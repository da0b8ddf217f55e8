"""Gradient clipping (port of `paddle_tpu.nn.clip`; reference
`python/paddle/fluid/clip.py`): by value, by each gradient's norm and by
the global norm.

Each class has two entries, as in the JAX package:
- `__call__(params_grads)` takes (parameter, gradient) pairs and passes a
  pair through unclipped when its gradient is None or its parameter has
  `need_clip` False (set by `ParamAttr(need_clip=False)`); such a pair
  takes no part in the global norm either (`paddle_tpu/nn/clip.py:32, 50,
  74, 83`).
- `_clip_grads(grads, whole_sq=None)` takes a list of gradients and
  clips every one: it is the optimizers' seam (`optimizer.Optimizer.
  step`), which ignores `need_clip` as the JAX package's `_tree_clip`
  does. `whole_sq` maps the gradients' sums of squares to those of the
  whole gradients where each is a rank's block of one
  (`parallel.spmd.clip_sharded`).
Everything stays on the device: no host sync."""
from __future__ import annotations

import torch

from ..ops._util import nest_leaves, nest_map

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_by_global_norm_pytree"]


def _clipped(p):
    return getattr(p, "need_clip", True)


class _ClipGradBase:
    def _clip_grads(self, grads, whole_sq=None):
        raise NotImplementedError

    def __call__(self, params_grads):
        """(param, grad) pairs -> pairs with clipped grads."""
        live = [i for i, (p, g) in enumerate(params_grads)
                if g is not None and _clipped(p)]
        if not live:
            return params_grads
        clipped = self._clip_grads([params_grads[i][1] for i in live])
        out = list(params_grads)
        for i, g in zip(live, clipped):
            out[i] = (out[i][0], g)
        return out


class ClipGradByValue(_ClipGradBase):
    """Clamp every gradient element into [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_grads(self, grads, whole_sq=None):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(_ClipGradBase):
    """Scale each gradient by clip_norm / its L2 norm where that norm
    exceeds clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_grads(self, grads, whole_sq=None):
        sq = [torch.sum(g * g) for g in grads]
        if whole_sq is not None:
            sq = whole_sq(sq)
        out = []
        for g, s in zip(grads, sq):
            n = torch.sqrt(s)
            out.append(g * torch.where(n > self.clip_norm,
                                       self.clip_norm / n, 1.0))
        return out


class ClipGradByGlobalNorm(_ClipGradBase):
    """Scale every gradient by clip_norm / max(global_norm, clip_norm),
    the global norm summed in float32 over all gradients in order — the
    JAX package's exact scale."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip_grads(self, grads, whole_sq=None):
        if not grads:
            return grads
        sq = [torch.sum(g.float() ** 2) for g in grads]
        if whole_sq is not None:
            sq = whole_sq(sq)
        gn = torch.sqrt(sum(sq))
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [g * scale.to(g.dtype) for g in grads]


def clip_by_global_norm_pytree(grads, clip_norm):
    """`ClipGradByGlobalNorm(clip_norm)` over a nest of tensors (lists,
    tuples and dicts), returned in the same structure."""
    it = iter(ClipGradByGlobalNorm(clip_norm)._clip_grads(
        nest_leaves(grads)))
    return nest_map(lambda _: next(it), grads)
