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
  `ops.linalg`; the flash kernels take bfloat16 and float16;
- quantized serving: int8 KV pages in `serving.GenerationEngine`
  (`kv_cache_dtype="int8"`), weight-only int8/int4 weights
  (`quantization.quantize_weights`, `quantization.WeightOnlyLinear`,
  `nn.quant`), and the fake-quant wrappers of
  `quantization.ImperativeQuantAware` / `PTQ`;
- serving observability and the host KV tier: `profiler` (RecordEvent,
  Profiler, the step and audit rings, spans, SLO, flight recorder,
  device telemetry, the HTTP exporter), `serving.failpoints`, and the
  host tier under the prefix cache (`serving.kv_tier`);
- the ERNIE/BERT encoder family: `models.{Ernie,Bert}{Model,
  ForSequenceClassification,ForPretraining}` over `nn.TransformerEncoder`
  (its `MultiHeadAttention` reaches the flash kernels on a key-padding
  mask), the rest of `nn`'s activations, its containers, transformer
  layers and `nn.initializer`, and `metric` through `hapi.Model`
  (`prepare(metrics=)`, fit / evaluate logs);
- convolutional vision: `nn`'s convolutions (1-3-D and transposed),
  pooling, BatchNorm / SyncBatchNorm / GroupNorm / InstanceNorm /
  LocalResponseNorm / SpectralNorm with their functionals,
  `vision.models` (ResNet, VGG, LeNet, MobileNetV1/V2) and
  `quantization.QuantizedConv2D`, on PyTorch's library convolutions
  (cuDNN), trained through `hapi.Model`;
- export and inference: `jit.save` / `jit.load` (a `torch.export`
  program with a symbolic batch dim, weight-only-quantized weights as
  runtime arguments), `inference.Config` / `create_predictor` /
  `Predictor`, the micro-batching `serving.InferenceEngine` over
  per-card dispatch lanes on CUDA streams, and `ops.math` (re-exported
  here: `paddle_tpu_torch.tanh`, ...). The flash forward kernel is the
  registered op `paddle_tpu_torch::flash_fwd`, so a saved program
  carries it and launches it on the card.
"""
from . import amp, framework, hapi, io, metric, models, nn, ops  # noqa: F401
from . import optimizer, profiler, quantization  # noqa: F401
from . import serving, static, vision  # noqa: F401
from . import inference, jit  # noqa: F401,E402
from .framework import get_flags, set_flags  # noqa: F401
from .ops.math import *  # noqa: F401,F403

__version__ = "0.1.0"
