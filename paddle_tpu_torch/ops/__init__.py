"""Ops. The kernel-backed ones (`flash_ops`, `paged_ops`, `splash_ops`)
build nothing at import: each CUDA kernel is compiled from
`paddle_tpu_torch/csrc` at its first launch. `math` holds the plain
elementwise and cumulative math ops, re-exported at the package's top
level (`paddle_tpu_torch.tanh`, ...)."""
from . import flash_ops, math, paged_ops, splash_ops  # noqa: F401
