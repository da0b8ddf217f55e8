"""Execute reference `.pdmodel` inference graphs (port of
`paddle_tpu.inference.pd_import`; reference `paddle/fluid/inference/api/
analysis_predictor.h:82` Run -> per-op executor loop; `fluid/inference/
io.cc` Load).

The parsed ProgramDesc block (`pd_format`) is bound op by op to torch
semantics and run in order on one device (the CUDA card unless the
caller asks for the CPU), the parameters placed there once. Covers the
op vocabulary v2.0 save_inference_model emits for MLP / CNN /
transformer-encoder graphs, with the reference's attribute rules
(`elementwise_*`'s `axis`, `matmul`'s transposes and `alpha`,
`lookup_table`'s trailing id dim and `padding_idx`, `pool2d`'s
`exclusive`); an unmapped op type raises UnimplementedError naming it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework.errors import UnimplementedError
from ..framework.place import resolve_device
from .pd_format import DTYPES, parse_program_desc, read_combined_params

__all__ = ["LegacyInferenceModel", "load_legacy_inference_model"]


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _bcast_y(x, y, axis):
    """elementwise_* `axis` semantics (reference
    `operators/elementwise/elementwise_op_function.h`): align y's dims to
    x starting at `axis` (or from the right when axis == -1)."""
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    ax = axis if axis >= 0 else x.dim() - y.dim()
    shape = [1] * x.dim()
    for i, d in enumerate(y.shape):
        shape[ax + i] = d
    return y.reshape(shape)


def _pads(pads):
    """[(top, bottom), (left, right)] from a 2- or 4-entry paddings."""
    if len(pads) == 2:
        return [(pads[0], pads[0]), (pads[1], pads[1])]
    return [(pads[0], pads[1]), (pads[2], pads[3])]


def _build_op(op_type: str, attrs: Dict[str, Any]) -> Callable:
    """op type + attrs -> fn(*input_tensors) -> output tensor. Input
    order matches _INPUT_ORDER below."""
    a = attrs

    if op_type == "mul":
        xd = a.get("x_num_col_dims", 1)
        yd = a.get("y_num_col_dims", 1)

        def fn(x, y):
            xm = x.reshape(int(np.prod(x.shape[:xd])), -1)
            ym = y.reshape(int(np.prod(y.shape[:yd])), -1)
            out = xm @ ym
            return out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))
        return fn
    if op_type in ("matmul", "matmul_v2"):
        tx = a.get("transpose_X", a.get("trans_x", False))
        ty = a.get("transpose_Y", a.get("trans_y", False))
        alpha = a.get("alpha", 1.0)

        def fn(x, y):
            if tx:
                x = x.transpose(-1, -2)
            if ty:
                y = y.transpose(-1, -2)
            return torch.matmul(x, y) * alpha
        return fn
    if op_type.startswith("elementwise_"):
        kind = op_type[len("elementwise_"):]
        base = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                "div": torch.div, "max": torch.maximum,
                "min": torch.minimum, "pow": torch.pow}.get(kind)
        if base is not None:
            axis = a.get("axis", -1)
            return lambda x, y: base(x, _bcast_y(x, y, axis))
    if op_type == "relu":
        return torch.relu
    if op_type == "gelu":
        approx = "tanh" if a.get("approximate", False) else "none"
        return lambda x: TF.gelu(x, approximate=approx)
    if op_type == "sigmoid":
        return torch.sigmoid
    if op_type == "tanh":
        return torch.tanh
    if op_type == "exp":
        return torch.exp
    if op_type == "sqrt":
        return torch.sqrt
    if op_type == "softmax":
        ax = a.get("axis", -1)
        return lambda x: torch.softmax(x, dim=ax)
    if op_type == "scale":
        s, b = a.get("scale", 1.0), a.get("bias", 0.0)
        after = a.get("bias_after_scale", True)
        return (lambda x: x * s + b) if after else (lambda x: (x + b) * s)
    if op_type in ("lookup_table_v2", "lookup_table"):
        pad = a.get("padding_idx", -1)

        def fn(w, ids):
            if op_type == "lookup_table" and ids.shape[-1] == 1:
                ids = ids.reshape(ids.shape[:-1])
            out = w[ids.long()]
            if pad is not None and pad >= 0:
                out = torch.where((ids == pad)[..., None],
                                  torch.zeros((), dtype=out.dtype,
                                              device=out.device), out)
            return out
        return fn
    if op_type in ("reduce_mean", "reduce_sum", "reduce_max", "reduce_min"):
        dims = tuple(a.get("dim", [0]))
        keep = a.get("keep_dim", False)
        if op_type in ("reduce_mean", "reduce_sum"):
            red = torch.mean if op_type == "reduce_mean" else torch.sum
            if a.get("reduce_all", False):
                return lambda x: red(x)
            return lambda x: red(x, dim=dims, keepdim=keep)
        red = torch.amax if op_type == "reduce_max" else torch.amin
        if a.get("reduce_all", False):
            return lambda x: red(x)
        return lambda x: red(x, dim=dims, keepdim=keep)
    if op_type in ("reshape2", "reshape"):
        shape = list(a.get("shape", []))

        def fn(x):
            return x.reshape([x.shape[i] if s == 0 else s
                              for i, s in enumerate(shape)])
        return fn
    if op_type in ("transpose2", "transpose"):
        perm = a.get("axis", [])
        return lambda x: x.permute(*perm)
    if op_type == "concat":
        ax = a.get("axis", 0)
        return lambda *xs: torch.cat(xs, dim=ax)
    if op_type == "stack":
        ax = a.get("axis", 0)
        return lambda *xs: torch.stack(xs, dim=ax)
    if op_type == "dropout":
        return lambda x: x          # inference graphs run is_test=True
    if op_type == "cast":
        out_dt = _torch_dtype(DTYPES.get(a.get("out_dtype", 5), np.float32))
        return lambda x: x.to(out_dt)
    if op_type == "batch_norm":
        eps = a.get("epsilon", 1e-5)

        def fn(x, scale, bias, mean, var):
            sh = (1, -1) + (1,) * (x.dim() - 2)
            return (x - mean.reshape(sh)) / torch.sqrt(
                var.reshape(sh) + eps) * scale.reshape(sh) + \
                bias.reshape(sh)
        return fn
    if op_type == "layer_norm":
        eps = a.get("epsilon", 1e-5)
        bna = a.get("begin_norm_axis", 1)

        def fn(x, scale, bias):
            axes = tuple(range(bna, x.dim()))
            m = x.mean(dim=axes, keepdim=True)
            v = ((x - m) ** 2).mean(dim=axes, keepdim=True)
            y = (x - m) / torch.sqrt(v + eps)
            sh = (1,) * bna + tuple(x.shape[bna:])
            return y * scale.reshape(sh) + bias.reshape(sh)
        return fn
    if op_type in ("conv2d", "depthwise_conv2d"):
        strides = tuple(a.get("strides", [1, 1]))
        (pt, pb), (pl, pr) = _pads(a.get("paddings", [0, 0]))
        dil = tuple(a.get("dilations", [1, 1]))
        groups = a.get("groups", 1)

        def fn(x, w):
            x = TF.pad(x, (pl, pr, pt, pb))
            return TF.conv2d(x, w, None, strides, 0, dil, groups)
        return fn
    if op_type == "pool2d":
        ptype = a.get("pooling_type", "max")
        ks = tuple(a.get("ksize", [2, 2]))
        strides = tuple(a.get("strides", ks))
        pads = tuple(a.get("paddings", [0, 0])[:2])
        exclusive = a.get("exclusive", True)
        if a.get("global_pooling", False):
            if ptype == "max":
                return lambda x: torch.amax(x, dim=(2, 3), keepdim=True)
            return lambda x: torch.mean(x, dim=(2, 3), keepdim=True)
        if ptype == "max":
            return lambda x: TF.max_pool2d(x, ks, strides, pads)
        # reference default: divide by the VALID cell count at the
        # borders (pool_op.h exclusive=True)
        return lambda x: TF.avg_pool2d(x, ks, strides, pads,
                                       count_include_pad=not exclusive)
    if op_type in ("squeeze2", "squeeze"):
        axes = tuple(a.get("axes", []))
        return lambda x: x.squeeze(axes) if axes else x.squeeze()
    if op_type in ("unsqueeze2", "unsqueeze"):
        axes = a.get("axes", [])

        def fn(x):
            for ax in sorted(axes):
                x = x.unsqueeze(ax)
            return x
        return fn
    if op_type == "slice":
        axes = a.get("axes", [])
        starts = a.get("starts", [])
        ends = a.get("ends", [])
        dec = a.get("decrease_axis", [])

        def fn(x):
            idx = [slice(None)] * x.dim()
            for ax, s, e in zip(axes, starts, ends):
                idx[ax] = slice(s, e)
            out = x[tuple(idx)]
            if dec:   # x[0]-style indexing drops the size-1 dims
                out = out.squeeze(tuple(dec))
            return out
        return fn
    if op_type == "assign":
        return lambda x: x
    if op_type == "arg_max":
        ax = a.get("axis", -1)
        return lambda x: torch.argmax(x, dim=ax).to(torch.int64)
    if op_type == "fill_constant":
        shape = a.get("shape", [])
        dt = _torch_dtype(DTYPES.get(a.get("dtype", 5), np.float32))
        val = a.get("value", 0.0)
        return lambda: torch.full(shape, val, dtype=dt)
    raise UnimplementedError(
        f"reference op type {op_type!r} has no mapping yet "
        f"(inference/pd_import.py)")


# slot order each op's impl expects (reference OpDesc input parameters)
_INPUT_ORDER = {
    "mul": ["X", "Y"], "matmul": ["X", "Y"], "matmul_v2": ["X", "Y"],
    "lookup_table_v2": ["W", "Ids"], "lookup_table": ["W", "Ids"],
    "batch_norm": ["X", "Scale", "Bias", "Mean", "Variance"],
    "layer_norm": ["X", "Scale", "Bias"],
    "conv2d": ["Input", "Filter"], "depthwise_conv2d": ["Input", "Filter"],
    "slice": ["Input"],
}
_OUTPUT_SLOT = {"batch_norm": "Y", "layer_norm": "Y", "conv2d": "Output",
                "depthwise_conv2d": "Output", "pool2d": "Out"}


class LegacyInferenceModel:
    """A loaded reference inference program, run op by op on `device`
    (the CUDA card unless the caller asks for the CPU)."""

    def __init__(self, program: Dict, params: Dict[str, np.ndarray],
                 device=None):
        self.device = resolve_device(device)
        if not program["blocks"]:
            raise ValueError("the ProgramDesc has no block")
        block = program["blocks"][0]
        self.feed_names: List[str] = []
        self.fetch_names: List[str] = []
        steps = []
        for op in block["ops"]:
            t = op["type"]
            if t == "feed":
                self.feed_names.append(op["outputs"]["Out"][0])
                continue
            if t == "fetch":
                self.fetch_names.append(op["inputs"]["X"][0])
                continue
            fn = _build_op(t, op["attrs"])
            order = _INPUT_ORDER.get(t)
            if order:
                in_names = [op["inputs"][k][0] for k in order
                            if op["inputs"].get(k)]
            else:
                in_names = list(op["inputs"].get("X", [])) + \
                    list(op["inputs"].get("Y", []))
            out_name = op["outputs"][_OUTPUT_SLOT.get(t, "Out")][0]
            steps.append((t, fn, in_names, out_name))
        if not self.fetch_names:
            raise ValueError("the ProgramDesc has no fetch op")
        self._steps = steps
        self._program = program
        self._host_params = params
        self._params = {k: torch.from_numpy(np.ascontiguousarray(v))
                        .to(self.device) for k, v in params.items()}

    def to(self, device) -> "LegacyInferenceModel":
        """The same model with its parameters on `device`."""
        return LegacyInferenceModel(self._program, self._host_params,
                                    device=device)

    def input_signature(self):
        """[(name, dims, numpy dtype)] of the feeds; -1 dims are None."""
        var = self._program["blocks"][0]["vars"]
        out = []
        for n in self.feed_names:
            v = var.get(n, {})
            dims = v.get("shape")
            dims = None if dims is None else tuple(
                None if d < 0 else int(d) for d in dims)
            out.append((n, dims, np.dtype(v.get("dtype", np.float32))))
        return out

    def run_device(self, feeds: List) -> List[torch.Tensor]:
        """Run on the feeds in `feed_names` order; device tensors out."""
        env = dict(self._params)
        env.update((n, torch.as_tensor(np.asarray(f)).to(self.device)
                    if not torch.is_tensor(f) else f.to(self.device))
                   for n, f in zip(self.feed_names, feeds))
        with torch.no_grad():
            for t, fn, in_names, out_name in self._steps:
                env[out_name] = fn(*[env[n] for n in in_names])
        return [env[n] for n in self.fetch_names]

    def run(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        outs = self.run_device([feed[n] for n in self.feed_names])
        return [o.cpu().numpy() for o in outs]


def load_legacy_inference_model(model_path: str, params_path: str = None,
                                device=None) -> LegacyInferenceModel:
    """Load reference `.pdmodel` (+ combined `.pdiparams`) onto `device`.

    Param order in the combined file follows sorted persistable-var names
    (`fluid/io.py` save_vars sorts by name before save_combine)."""
    with open(model_path, "rb") as f:
        program = parse_program_desc(f.read())
    params: Dict[str, np.ndarray] = {}
    if params_path:
        names = sorted(n for n, v in program["blocks"][0]["vars"].items()
                       if v["persistable"])
        with open(params_path, "rb") as f:
            params = read_combined_params(f.read(), names)
    return LegacyInferenceModel(program, params, device=device)
