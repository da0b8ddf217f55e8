"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

This package imports `torch` and never `jax`, and nothing of
`paddle_tpu`. Its entry points run on the CUDA card unless the caller
passes `device="cpu"`; asking for the card where there is none raises.
Each TPU kernel on the ported path is a hand-written CUDA kernel under
`csrc/`, built by `nvcc` at its first launch (`ops/_build.py`), with a
plain PyTorch version beside it that CPU tensors take.

Ported so far:
- GPT generative serving: `models.GPTForCausalLM`,
  `serving.GenerationEngine` over `serving.PagedKVCache`, the paged
  decode attention kernel and the flash-attention forward kernel;
- training: `hapi.Model` (prepare / fit / evaluate / save / load) over
  `io.DataLoader`, `optimizer.{SGD,Momentum,Adam,AdamW}` with
  `optimizer.lr` schedulers and `nn.ClipGradByGlobalNorm`,
  `nn.CrossEntropyLoss`, and flash attention with dropout, forward and
  backward (`ops.flash_ops.FlashAttention`, three CUDA kernels);
- packed variable-length training: `io.PackingCollator`, the token-masked
  loss of `hapi.Model` (fit / evaluate / predict), `static.InputSpec`,
  and segment-aware splash attention through
  `F.scaled_dot_product_attention(segment_ids=...)`
  (`ops.splash_ops.SplashAttention`, three CUDA kernels);
- AMP: `amp.auto_cast` / `amp_guard` (O1, bfloat16 or float16),
  `amp.decorate` (O2), `amp.GradScaler` and
  `hapi.Model.prepare(amp_configs=...)`, casting by op name through the
  `nn` layers and functionals (`Linear`, `Embedding`, `LayerNorm`,
  `GELU`, `Dropout`; `linear`, `layer_norm`, `softmax`, ...) and
  `ops.linalg`; the flash kernels take bfloat16 and float16.
"""
from . import amp, framework, hapi, io, models, nn, ops  # noqa: F401
from . import optimizer  # noqa: F401
from . import serving, static  # noqa: F401
from .framework import get_flags, set_flags  # noqa: F401

__version__ = "0.1.0"
