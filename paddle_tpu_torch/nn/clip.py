"""Gradient clipping by global norm (port of
`paddle_tpu.nn.clip.ClipGradByGlobalNorm`, `clip.py:66-94` there;
reference `python/paddle/fluid/clip.py`)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by clip_norm / max(global_norm, clip_norm),
    the global norm summed in float32 over all gradients in order — the
    JAX package's exact scale. Stays on the device: no host sync."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip_grads(self, grads):
        """Clipped copies of a list of gradient tensors."""
        if not grads:
            return grads
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [g * scale.to(g.dtype) for g in grads]

    def __call__(self, params_grads):
        """(param, grad) pairs -> pairs with clipped grads; a None grad
        passes through and takes no part in the norm."""
        live = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        clipped = self._clip_grads([params_grads[i][1] for i in live])
        out = list(params_grads)
        for i, g in zip(live, clipped):
            out[i] = (out[i][0], g)
        return out
