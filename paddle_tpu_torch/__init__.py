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
- the top-level API and the dense ops: `to_tensor`, the op families of
  `ops.{creation,manipulation,logic,reduction,search,random_ops,linalg}`
  re-exported here (`paddle_tpu_torch.concat`, `.zeros`, `.argmax`,
  ...; `random` is `random_ops`), `ops.tensor_methods` (the reference's
  Tensor methods mapped onto torch's), `autograd` (`grad`, `PyLayer`,
  `vjp`, `jvp`, `jacobian`, `hessian`), `Model` (hapi), `seed` and the
  generator states, `save` / `load` (the reference's pickled numpy
  format), `ParamAttr`, the dtypes and `set_default_dtype`, the places
  with `set_device` / `get_device` (the default device is the CUDA
  card; `set_device("cpu")` asks for the CPU) and `device`;
- GPT's mixture-of-experts feed-forward (`GPTConfig(use_moe=True)`,
  `models.gpt.MoEFeedForward`), trained through `Model`;
- the rest of `nn`: `nn.Layer` (a torch module with the reference's
  methods), the recurrent layers (`LSTM`, `GRU`, `SimpleRNN`, the
  cells, `RNN`, `BiRNN`), `BeamSearchDecoder` / `dynamic_decode`, the
  remaining losses and common layers with their functionals, gradient
  clipping by value and by norm, `nn.utils`, `ParamAttr`'s `need_clip`,
  the optimizers Adamax, Adagrad, Adadelta, RMSProp, Lamb and
  LarsMomentum, and `affine_grid` / `gather_tree` here; with them
  `models.seq2seq`, an attention LSTM encoder-decoder built from either
  package's public API;
- the input pipeline and the rest of hapi: `io`'s worker processes over
  a shared-memory ring, its thread workers and iterable datasets, the
  dataset combinators and samplers, `io.DeviceFeeder` (pinned copies on
  a side CUDA stream), tail bucketing in `Model`, the callbacks
  `EarlyStopping` and `VisualDL` (here as `callbacks`), `summary` and
  `flops`, `utils`, `vision.transforms`, `vision.datasets` and `text`;
- static graph mode: `enable_static` / `disable_static` and the mode
  names, `data`, `static.{Program, Executor, program_guard, nn, amp,
  save_inference_model, load_inference_model}`, the op-level document
  and passes, `Optimizer.minimize`, dy2static in `jit.to_static`, the
  quantization passes, and the reference's ProgramDesc `.pdmodel`
  through `inference.Predictor`;
- multi-GPU, one process a card over `torch.distributed` (NCCL on the
  card, gloo on the CPU): `parallel.{mesh, spmd}` (meshes over ranks,
  `make_sharded_train_step` with ZeRO 0-3 and tensor-parallel layers,
  `sharded_splash_attention`), `distributed` (`init_parallel_env`, the
  collectives, `spawn` and `python -m paddle_tpu_torch.distributed.
  launch`, `DataParallel`, the tensor-parallel layers, `sharding`),
  `io.DistributedBatchSampler`, `framework.sharded_checkpoint`, and
  tensor-parallel serving lanes in `serving.GenerationEngine`
  (`GenerationConfig(tp=)`, `ops.paged_ops.sharded_paged_attention`,
  `models.gpt.shard_decode_weights`);
- fleet's strategies: the differentiable `distributed.ppermute` /
  `all_to_all`, `parallel.{ring_attention, pipeline, localsgd,
  compression}` (ring and Ulysses attention, GPipe and 1F1B, LocalSGD,
  DGC), `make_sharded_train_step(sp_axis=, dgc=)`, GPT's `use_ring` and
  `pipeline_sections()`, `distributed.fleet` (strategy, role makers,
  utils, metrics, `fleet`, the elastic heartbeat), `launch --elastic`
  and `Model.fit` through fleet;
- export and inference, the rest: `onnx.export` (ONNX-13 from the
  layer's decomposed `torch.export` program, K2's op lowered to what its
  plain version computes), the C inference API (`csrc/pd_c_api.h`,
  `inference.capi.build()`), and the fluid-era names of `ops.legacy`
  (`legacy` here: `elementwise_*`, `reduce_*`, tensor arrays, LoD
  `sequence_*` ops, `Print`, `create_parameter` / `create_global_var`
  as Program parameters and globals, `search_pyramid_hash`);
- the detection slice: `vision.ops` (box IoU, RoI align and pooling,
  yolo_box, box_coder, yolov3_loss, the anchor and prior generators, and
  the NMS family, whose sort and IoU matrices run on the card and whose
  greedy scan runs on the host), `vision.models.YOLOv3`, the rest of
  `ops.extra_ops` (re-exported in `nn.functional`, `ops.legacy` and
  here), and `incubate` (LookAhead, ModelAverage, GradientMerge,
  Recompute, the auto-checkpoint epoch range).
"""
from . import amp, framework, hapi, io, metric, models, nn, ops  # noqa: F401
from . import optimizer, profiler, quantization  # noqa: F401
from . import serving, static, vision  # noqa: F401
from . import inference, jit  # noqa: F401,E402
from . import autograd, device  # noqa: F401,E402
from . import text, utils  # noqa: F401,E402
from . import distributed, parallel  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import onnx  # noqa: F401,E402
from .distributed import DataParallel  # noqa: F401,E402
from .hapi import callbacks  # noqa: F401,E402
from .hapi.model_summary import flops, summary  # noqa: F401,E402
from .framework import get_flags, set_flags  # noqa: F401
from .ops import *  # noqa: F401,F403
from .ops import (creation, linalg, logic, manipulation, math,  # noqa: F401
                  reduction, search, tensor_methods)
from .ops import random_ops as random  # noqa: F401
from .framework.dtype import (DType, bfloat16, bool_, complex64,  # noqa: F401
                              complex128, float16, float32, float64,
                              get_default_dtype, int8, int16, int32, int64,
                              set_default_dtype, uint8)
from .framework.place import (CPUPlace, CUDAPinnedPlace,  # noqa: F401
                              CUDAPlace, NPUPlace, Place, TPUPlace, XPUPlace,
                              device_count, get_cudnn_version, get_device,
                              is_compiled_with_cuda, is_compiled_with_npu,
                              is_compiled_with_tpu, is_compiled_with_xpu,
                              set_device)
from .framework.random import (get_cuda_rng_state,  # noqa: F401
                               get_rng_state, rng_scope, seed,
                               set_cuda_rng_state, set_rng_state)
from .framework.io_state import load, save  # noqa: F401
from .framework.param_attr import ParamAttr  # noqa: F401
from .autograd import enable_grad, grad, is_grad_enabled, no_grad  # noqa
from .hapi.model import Model  # noqa: F401
from .ops.extra_ops import affine_grid, gather_tree  # noqa: F401



def _inplace_fn(name):
    """The reference's top-level in-place alias `name` (`paddle.reshape_(
    x, shape)`, ...): the Tensor method's entry of `tensor_methods`."""
    def fn(x, *args, **kwargs):
        return tensor_methods.call(x, name, *args, **kwargs)
    fn.__name__ = fn.__qualname__ = name
    return fn


reshape_ = _inplace_fn("reshape_")
scatter_ = _inplace_fn("scatter_")
squeeze_ = _inplace_fn("squeeze_")
unsqueeze_ = _inplace_fn("unsqueeze_")
tanh_ = _inplace_fn("tanh_")
clip_ = _inplace_fn("clip_")
scale_ = _inplace_fn("scale_")
flatten_ = _inplace_fn("flatten_")
exp_ = _inplace_fn("exp_")
sqrt_ = _inplace_fn("sqrt_")

from .static.program import data, disable_static, enable_static  # noqa
from .static.program import in_static_mode as _in_static  # noqa: E402


def monkey_patch_math_varbase():
    """No-op, as in the JAX package: a torch tensor carries its operators
    and the reference's Tensor methods (`ops.tensor_methods`) already."""


def monkey_patch_variable():
    """No-op: a static Program's Variables are torch tensors with the same
    methods."""


def in_dynamic_mode():
    return not _in_static()


def in_dygraph_mode():
    return not _in_static()


def enable_dygraph(place=None):
    disable_static(place)


def disable_dygraph():
    enable_static()


__version__ = "0.1.0"
