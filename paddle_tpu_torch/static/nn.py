"""paddle.static.nn — the static-graph layer API (port of
`paddle_tpu.static.nn`; reference `python/paddle/static/nn/`
re-exporting `fluid/layers/nn.py` fc/conv2d/...).

Each wrapper builds the same layer the dygraph API uses; in static mode
its ops record into the current Program. The control flow (`cond`,
`while_loop`, `switch_case`) records ONE op in static mode whose
branches are sub-blocks of the Program: the op replays the taken
branch's block with the values of the Variables the branches read, and
under `torch.export` (a fake predicate) lowers to `torch.cond` /
`torch._higher_order_ops.while_loop`. Outside static mode it runs plain
Python on a concrete predicate, as the reference's dygraph does.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils import _pytree as pytree

from .. import nn as _nn
from ..framework import static_hook
from ..framework.dtype import to_torch_dtype
from ..nn import functional as F
from ..framework.place import resolve_device
from . import program as _prog

__all__ = ["fc", "conv2d", "conv3d", "batch_norm", "embedding", "dropout",
           "layer_norm", "conv2d_transpose", "cond", "while_loop",
           "switch_case", "case"]


def _on_place():
    """Layers a wrapper makes are built on the default place (the card
    unless the thread asked for the CPU), where `data` puts its
    placeholders."""
    return torch.device(resolve_device(None))


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    from ..ops.manipulation import flatten
    inp = x
    if num_flatten_dims > 1 or len(x.shape) > 2:
        inp = flatten(x, num_flatten_dims, -1) if num_flatten_dims >= 1 \
            else x
    with _on_place():
        layer = _nn.Linear(inp.shape[-1], size, weight_attr=weight_attr,
                           bias_attr=bias_attr)
    out = layer(inp)
    if activation:
        out = getattr(F, activation)(out)
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None, use_cudnn=True):
    ch_axis = 1 if data_format == "NCHW" else -1
    with _on_place():
        layer = _nn.Conv2D(input.shape[ch_axis], num_filters, filter_size,
                           stride, padding, dilation, groups,
                           weight_attr=param_attr, bias_attr=bias_attr,
                           data_format=data_format)
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None):
    with _on_place():
        layer = _nn.Conv3D(input.shape[1], num_filters, filter_size, stride,
                           padding, dilation, groups, weight_attr=param_attr,
                           bias_attr=bias_attr, data_format=data_format)
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    with _on_place():
        layer = _nn.Conv2DTranspose(input.shape[1], num_filters,
                                    filter_size, stride, padding,
                                    dilation=dilation, groups=groups,
                                    weight_attr=param_attr,
                                    bias_attr=bias_attr,
                                    data_format=data_format)
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, name=None, **kwargs):
    ch = input.shape[1 if data_layout == "NCHW" else -1]
    with _on_place():
        layer = _nn.BatchNorm(ch, act=act, momentum=momentum,
                              epsilon=epsilon, param_attr=param_attr,
                              bias_attr=bias_attr, data_layout=data_layout)
    if is_test:
        layer.eval()
    return layer(input)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    shape = list(input.shape[begin_norm_axis:])
    with _on_place():
        layer = _nn.LayerNorm(shape, eps=epsilon,
                              elementwise_affine=bool(scale or shift),
                              bias=bool(shift))
    if shift and not scale:
        layer.weight = None
    with static_hook.suppressed():   # initialisers are not ops
        for attr, p in ((param_attr, layer.weight), (bias_attr, layer.bias)):
            init = getattr(attr, "initializer", None) or (
                attr if callable(attr) else None)
            if init is not None and p is not None:
                init(p.data)
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    with _on_place():
        layer = _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                              sparse=is_sparse, weight_attr=param_attr)
    return layer(input)


def dropout(x, dropout_prob=0.5, is_test=False, name=None, **kwargs):
    return F.dropout(x, dropout_prob, training=not is_test)


# ---------------------------------------------------------------------------
# control flow (reference `fluid/layers/control_flow.py` cond/While ->
# conditional_block_op / while_op)
# ---------------------------------------------------------------------------

def _traced(t) -> bool:
    """A predicate whose value is not known here: a fake tensor of a
    `torch.export` trace."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or (
        torch.is_tensor(t) and torch._guards.detect_fake_mode((t,))
        is not None)


def _recording_on(pred) -> bool:
    """Record a control-flow op: static mode and a tensor predicate."""
    return static_hook.recording() and torch.is_tensor(pred)


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x)


class _Branch:
    """A recorded branch: its sub-block and its return leaves (slots of
    Variables, or constants)."""

    def __init__(self, program, idx, ret):
        self.program = program
        self.block = program.blocks[idx]
        leaves, self.spec = pytree.tree_flatten(ret)
        self.leaves = [(_prog._slot_of(l), l) for l in leaves]

    def run(self, env):
        env = dict(env)
        _prog.run_ops(self.program, self.block.ops, env)
        out = []
        for s, l in self.leaves:
            if s is not None:
                out.append(env[s] if s in env else l)
            else:
                out.append(_as_tensor(l))
        return out


def _sub_blocks(prog, named_fns):
    """Record each (attr name, fn) into a sub-block; returns (attrs,
    branches, external Variables in first-seen order)."""
    attrs, branches, ext = {}, [], {}
    for name, fn in named_fns:
        idx, blk_ext, ret = prog._record_sub_block(fn)
        attrs[name] = idx
        branches.append(_Branch(prog, idx, ret))
        for s, v in blk_ext.items():
            ext.setdefault(s, v)
    return attrs, branches, list(ext.values())


def _record_cf(name, impl, inputs, attrs, spec):
    """Record control-flow op `name` over `inputs`; returns its outputs
    unflattened as `spec`."""
    outs = _prog.apply_op(name, impl, inputs, attrs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    return pytree.tree_unflatten(outs, spec)


def cond(pred, true_fn=None, false_fn=None, name=None):
    if _recording_on(pred):
        prog = _prog.default_main_program()
        attrs, (tb, fb), ext = _sub_blocks(
            prog, [("sub_block", true_fn), ("sub_block_false", false_fn)])
        ext_slots = [v.slot for v in ext]

        def impl(p, *ext_vals, _tb=tb, _fb=fb, _slots=tuple(ext_slots)):
            env = dict(zip(_slots, ext_vals))
            if _traced(p):
                return tuple(torch.cond(
                    p.reshape(()).bool(),
                    lambda *e: tuple(_tb.run(dict(zip(_slots, e)))),
                    lambda *e: tuple(_fb.run(dict(zip(_slots, e)))),
                    tuple(ext_vals)))
            return tuple((_tb if bool(p) else _fb).run(env))
        return _record_cf("cond", impl, (pred, *ext), attrs, tb.spec)
    if _traced(pred):
        return torch.cond(pred.reshape(()).bool(),
                          lambda: true_fn(), lambda: false_fn(), ())
    return true_fn() if bool(pred) else false_fn()


def _while_traced(cond_fn, body_fn, flat, spec):
    from torch._higher_order_ops.while_loop import while_loop as _wl

    def c(*vals):
        return _as_tensor(cond_fn(*pytree.tree_unflatten(list(vals), spec)))

    def b(*vals):
        out = body_fn(*pytree.tree_unflatten(list(vals), spec))
        return tuple(pytree.tree_leaves(out))
    return list(_wl(c, b, tuple(flat)))


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    flat, spec = pytree.tree_flatten(tuple(loop_vars))
    if static_hook.recording():
        prog = _prog.default_main_program()
        # the carry enters the branches as fresh Variables, so the
        # sub-blocks read it through slots, constants included
        flat = [_as_tensor(v) for v in flat]
        ph = [_prog._new_var(v) for v in flat]
        ph_vars = pytree.tree_unflatten(ph, spec)
        attrs, (bb, cb), ext = _sub_blocks(prog, [
            ("sub_block", lambda: tuple(body_fn(*ph_vars))),
            ("cond_block", lambda: cond_fn(*ph_vars))])
        ph_slots = tuple(v.slot for v in ph)
        ext = [v for v in ext if v.slot not in ph_slots]
        ext_slots = tuple(v.slot for v in ext)
        n = len(flat)

        def impl(*vals, _bb=bb, _cb=cb):
            carry, ext_vals = list(vals[:n]), list(vals[n:])
            base = dict(zip(ext_slots, ext_vals))

            def env_of(c):
                e = dict(base)
                e.update(zip(ph_slots, c))
                return e
            if any(_traced(v) for v in vals):
                from torch._higher_order_ops.while_loop import \
                    while_loop as _wl
                return tuple(_wl(
                    lambda *c: _cb.run(env_of(c))[0].reshape(()).bool(),
                    lambda *c: tuple(_bb.run(env_of(c))),
                    tuple(carry)))
            while bool(_cb.run(env_of(carry))[0]):
                carry = _bb.run(env_of(carry))
            return tuple(carry)
        return list(_record_cf("while", impl, (*flat, *ext), attrs, spec))
    if any(_traced(v) for v in flat):
        return pytree.tree_unflatten(
            _while_traced(cond_fn, body_fn, flat, spec), spec)
    vals = tuple(loop_vars)
    while bool(cond_fn(*vals)):
        vals = tuple(body_fn(*vals))
    return list(vals) if isinstance(loop_vars, list) else vals


def case(pred_fn_pairs, default=None, name=None):
    for pred, fn in pred_fn_pairs:
        if bool(pred):
            return fn()
    return default() if default else None


def switch_case(branch_index, branch_fns, default=None, name=None):
    fns = branch_fns
    if isinstance(branch_fns, dict):
        fns = [branch_fns[k] for k in sorted(branch_fns)]
    elif fns and isinstance(fns[0], tuple):
        fns = [f for _, f in sorted(fns)]
    if _recording_on(branch_index):
        prog = _prog.default_main_program()
        attrs, branches, ext = _sub_blocks(
            prog, [(f"sub_block_{i}", f) for i, f in enumerate(fns)])
        ext_slots = tuple(v.slot for v in ext)

        def impl(idx, *ext_vals, _br=tuple(branches)):
            env = dict(zip(ext_slots, ext_vals))
            if _traced(idx):
                def pick(k):
                    if k == len(_br) - 1:
                        return lambda *e: tuple(_br[k].run(
                            dict(zip(ext_slots, e))))
                    return lambda *e: tuple(torch.cond(
                        idx.reshape(()) == k,
                        lambda *e2: tuple(_br[k].run(
                            dict(zip(ext_slots, e2)))),
                        pick(k + 1), e))
                return pick(0)(*ext_vals)
            k = int(idx)
            k = min(max(k, 0), len(_br) - 1)   # lax.switch clamps
            return tuple(_br[k].run(env))
        return _record_cf("switch_case", impl, (branch_index, *ext), attrs,
                          branches[0].spec)
    k = int(branch_index)
    k = min(max(k, 0), len(fns) - 1)
    return fns[k]()


# ---------------------------------------------------------------------------
# fluid.layers-style wrappers (reference `fluid/layers/nn.py`)
# ---------------------------------------------------------------------------

# name -> parameter caches, scoped PER default program (WeakKeyDictionary:
# dropping a Program drops its share cache)
_shared_params = weakref.WeakKeyDictionary()


def _create_parameter(shape, dtype, attr=None, is_bias=False, name=None):
    p = _nn.Layer().create_parameter(list(shape), attr=attr, dtype=dtype,
                                     is_bias=is_bias)
    if name is not None:
        p._pt_name = name
    return p


def _validate_shared(p, shape, dtype, name):
    p_shape = tuple(int(s) for s in p.shape)
    if p_shape != tuple(int(s) for s in shape):
        raise ValueError(
            f"shared_parameter {name!r}: existing parameter has shape "
            f"{list(p_shape)}, requested {list(shape)} — a param_attr name "
            f"shares storage, so call sites must agree on the geometry")
    want = to_torch_dtype(dtype)
    if p.dtype != want:
        raise ValueError(
            f"shared_parameter {name!r}: existing parameter has dtype "
            f"{p.dtype}, requested {want}")
    return p


def shared_parameter(shape, dtype, attr=None, is_bias=False,
                     default_name=None):
    """fluid LayerHelper contract: a param_attr WITH a name shares the
    parameter across call sites (reference `fluid/layer_helper_base.py`
    create_parameter); unnamed attrs create fresh parameters per call.
    Sharing is scoped to the current default program and a shape/dtype
    mismatch under the same name raises."""
    name = getattr(attr, "name", attr if isinstance(attr, str) else None)
    if name is None:
        return _create_parameter(shape, dtype, attr=attr, is_bias=is_bias,
                                 name=default_name)
    prog = _prog.default_main_program()
    if _prog.in_static_mode():
        reg = prog.param_vars
        if name in reg:
            return _validate_shared(reg[name], shape, dtype, name)
    cache = _shared_params.setdefault(prog, {})
    if name in cache:
        return _validate_shared(cache[name], shape, dtype, name)
    p = _create_parameter(shape, dtype, attr=None if isinstance(attr, str)
                          else attr, is_bias=is_bias, name=name)
    cache[name] = p
    return p


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           data_format="NCHW", name=None):
    if global_pooling:
        axis = (2, 3) if data_format == "NCHW" else (1, 2)
        from ..ops import reduction
        red = reduction.max if pool_type == "max" else reduction.mean
        return red(input, axis=axis, keepdim=True)
    fn = F.max_pool2d if pool_type == "max" else F.avg_pool2d
    return fn(input, pool_size, pool_stride, pool_padding,
              ceil_mode=ceil_mode, data_format=data_format)


def relu(x, name=None):
    return F.relu(x)


def softmax(input, axis=-1, name=None):
    return F.softmax(input, axis=axis)


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """fluid.layers.cross_entropy contract: `input` is POST-softmax
    probabilities (-log p[label]); use_softmax=False avoids a double
    softmax."""
    return F.cross_entropy(input, label, soft_label=soft_label,
                           ignore_index=ignore_index, reduction="none",
                           use_softmax=False)


def mean(x, name=None):
    from ..ops import reduction
    return reduction.mean(x)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    import numpy as _np

    from ..ops.linalg import matmul
    from ..ops.manipulation import reshape
    xs, ys = list(x.shape), list(y.shape)
    if len(xs) > 2:
        x = reshape(x, [int(_np.prod(xs[:x_num_col_dims])), -1])
    if len(ys) > 2:
        y = reshape(y, [int(_np.prod(ys[:y_num_col_dims])), -1])
    return matmul(x, y)


def concat(input, axis=0, name=None):
    from ..ops.manipulation import concat as _concat
    return _concat(input, axis)


def accuracy(input, label, k=1, name=None):
    def impl(pred, lab):
        idx = torch.argsort(-pred, dim=-1, stable=True)[:, :k]
        hit = (idx == lab.reshape(-1, 1)).any(dim=1)
        return hit.to(torch.float32).mean()
    return _prog.apply_op("accuracy", impl, (input, label))


def topk(input, k, name=None):
    from ..ops.search import topk as _topk
    return _topk(input, k)


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    return F.normalize(x, p=2, axis=axis, epsilon=epsilon)


def one_hot(input, depth, name=None):
    return F.one_hot(input, depth)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    from ..ops import reduction
    return reduction.sum(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    from ..ops import reduction
    return reduction.mean(input, axis=dim, keepdim=keep_dim)


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    """reference `sigmoid_cross_entropy_with_logits_op.cc`: elementwise
    BCE-with-logits where label==ignore_index contributes 0; normalize
    divides by the non-ignored count."""
    def impl(lv, yv):
        loss = torch.clamp(lv, min=0.0) - lv * yv + torch.log1p(
            torch.exp(-torch.abs(lv)))
        keep = yv != ignore_index
        loss = torch.where(keep, loss, torch.zeros_like(loss))
        if normalize:
            loss = loss / torch.clamp(keep.sum().to(loss.dtype), min=1.0)
        return loss
    return _prog.apply_op("sigmoid_cross_entropy_with_logits", impl,
                          (x, label))


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """reference `fluid/layers/nn.py` lstm_unit / `lstm_unit_op.cc`:
    FC(concat(x, h)) -> i,f,c~,o with forget_bias added to the forget
    gate pre-activation; returns (hidden, cell). The weight is [in + D,
    4D], as the reference's."""
    D = hidden_t_prev.shape[-1]
    w = shared_parameter([x_t.shape[-1] + D, 4 * D], "float32",
                         attr=param_attr)
    b = shared_parameter([4 * D], "float32", attr=bias_attr,
                         is_bias=True)

    def impl(x, h, c, wv, bv):
        z = torch.cat([x, h], dim=-1) @ wv + bv
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + forget_bias)
        o = torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        return o * torch.tanh(c_new), c_new
    h, c = _prog.apply_op("lstm_unit", impl,
                          (x_t, hidden_t_prev, cell_t_prev, w, b))
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """reference `gru_unit_op.cc`: input is the PRE-PROJECTED [B, 3*D]
    tensor (D = size//3); hidden weights [D, 3*D] live in this op.
    Returns (hidden, reset_hidden_prev, gate)."""
    D = size // 3
    w = shared_parameter([D, 3 * D], "float32", attr=param_attr)
    b = shared_parameter([3 * D], "float32", attr=bias_attr, is_bias=True)
    act = torch.tanh if activation == "tanh" else torch.relu

    def impl(x, h, wv, bv):
        x = x + bv
        xu, xr, xc = torch.chunk(x, 3, dim=-1)
        wu, wr, wc = torch.chunk(wv, 3, dim=-1)
        u = torch.sigmoid(xu + h @ wu)
        r = torch.sigmoid(xr + h @ wr)
        rh = r * h
        c = act(xc + rh @ wc)
        h_new = (1.0 - u) * h + u * c
        gate = torch.cat([u, r, c], dim=-1)
        return h_new, rh, gate
    return _prog.apply_op("gru_unit", impl, (input, hidden, w, b))


__all__ += ["pool2d", "relu", "softmax", "cross_entropy", "mean", "mul",
            "concat", "accuracy", "topk", "l2_normalize", "one_hot",
            "reduce_sum", "reduce_mean",
            "sigmoid_cross_entropy_with_logits", "lstm_unit", "gru_unit",
            "shared_parameter"]
