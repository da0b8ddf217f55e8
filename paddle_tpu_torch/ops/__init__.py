"""Kernel-backed ops. Importing this package builds nothing: each CUDA
kernel is compiled from `paddle_tpu_torch/csrc` at its first launch."""
from . import flash_ops, paged_ops, splash_ops  # noqa: F401
