"""Model summary (port of `paddle_tpu.hapi.model_summary`; reference
`python/paddle/hapi/model_summary.py` and `hapi/dynamic_flops.py`).

`summary` tables the network's parameters: names, shapes and counts, as
the JAX package's does. A shape is the port's own: a `Linear` weight
prints as [out_features, in_features], PyTorch's layout, where the JAX
package prints [in, out]; names and counts are the same. `flops` runs
one forward of zeros in eval mode with forward hooks on the
convolutions and `Linear` layers (and on `custom_ops`' layer types) and
sums 2 x multiply-adds, as the JAX package counts them."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["summary", "flops"]


def flops(net, input_size, custom_ops=None, print_detail=False):
    """FLOPs of one forward at `input_size`, counted per layer type:
    2 x output elements x (input channels / groups) x kernel size for
    `Conv1D/2D/3D`, 2 x output elements x in_features for `Linear`, and
    `custom_ops[type name](layer, inputs, output)` for the types it
    names."""
    total = [0]
    hooks = []

    def conv_hook(layer, inputs, output):
        k = int(np.prod(layer._kernel_size))
        cin = layer._in_channels // layer._groups
        total[0] += 2 * int(np.prod(output.shape)) * cin * k

    def linear_hook(layer, inputs, output):
        total[0] += 2 * int(np.prod(output.shape)) * layer.in_features

    for layer in net.modules():
        tn = type(layer).__name__
        if tn in ("Conv2D", "Conv1D", "Conv3D"):
            hooks.append(layer.register_forward_hook(conv_hook))
        elif tn == "Linear":
            hooks.append(layer.register_forward_hook(linear_hook))
        elif custom_ops and tn in custom_ops:
            fn = custom_ops[tn]
            hooks.append(layer.register_forward_hook(
                lambda l, i, o, fn=fn: total.__setitem__(
                    0, total[0] + fn(l, i, o))))
    p = next(net.parameters(), None)
    x = torch.zeros(tuple(input_size), dtype=torch.float32,
                    device=p.device if p is not None else "cpu")
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print the parameter table and return `{"total_params",
    "trainable_params"}`; `input_size`, `dtypes` and `input` are accepted
    and not read, as in the JAX package."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(tuple(p.shape))) if p.dim() else 1
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    lines = ["-" * (width + 30),
             f"{'Param':<{width}}{'Shape':<20}{'Count':>8}",
             "-" * (width + 30)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>8}")
    lines += ["-" * (width + 30),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * (width + 30)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
