"""Common functionals: `linear`, `dropout`, `embedding` (port of
`paddle_tpu.nn.functional.common`, `common.py:18-83` there; reference
`python/paddle/nn/functional/common.py`, `input.py`).

`linear` is AMP's white op "linear"; `dropout` and `embedding` are in
no list and run in the type that reaches them, unless a custom list of
`auto_cast` names them (every op of the JAX package is named)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...ops.linalg import promoted

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with the JAX package's weight layout
    [in_features, out_features] (`nn.Linear` keeps PyTorch's [out, in]
    and passes its transpose, a view). Under AMP the float32 operands
    are cast to the autocast type. The bias is added inside the GEMM's
    epilogue (`torch.nn.functional.linear`), so a bfloat16 product is
    rounded once; the JAX package rounds `x @ W` and then adds the bias
    in bfloat16."""
    args = (x, weight) if bias is None else (x, weight, bias)
    x, w, *b = promoted(*amp.cast_args("linear", *args))
    return TF.linear(x, w.t(), b[0] if b else None)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability p (one draw per position of
    the axes in `axis` when given, shared along the others). Mode
    "upscale_in_train" scales the kept ones by 1 / (1 - p);
    "downscale_in_infer" keeps them as they are. Out of training, or at
    p 0, `x` itself, as in the JAX package. Draws from torch's default
    generator of x's device."""
    if not training or p == 0.0:
        return x
    (x,) = amp.cast_args("dropout", x)
    if axis is None and mode == "upscale_in_train":
        return TF.dropout(x, p, True)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [num_embeddings, dim] at the integer ids `x`; a
    position whose id is `padding_idx` gives zeros (and no gradient), as
    in the JAX package. `sparse` is accepted and unused."""
    x, weight = amp.cast_args("embedding", x, weight)
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out
