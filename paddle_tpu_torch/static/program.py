"""Static graph: Program / Executor / program_guard (port of
`paddle_tpu.static.program`; reference `python/paddle/fluid/
framework.py` Program/Block/Operator, `fluid/executor.py:916`
Executor.run).

A Program is a recorded op list: each entry holds a callable over torch
tensors and the SSA slots of its inputs and outputs, as in the JAX
package. While static mode is on (`enable_static`), every op runs once
on placeholder values, for shapes and types, and is recorded into the
current block of the default main program:

- a named op of the port (a function marked `framework.static_hook.
  named_op`: `linear`, `sdpa`, `layer_norm`, `embedding`, `dropout`,
  `cross_entropy`, ...) is ONE op under the name its `amp.cast_args`
  announces, with nothing inside it recorded again;
- every other torch call whose inputs include a Variable or a parameter
  is one op, caught by a `TorchFunctionMode` (`_Recorder`) that
  `enable_static` pushes on the thread's mode stack, and named as the
  JAX package names it (`add`, `multiply`, `getitem`, `reshape`,
  `transpose`, `concat`, ...; `_TORCH_NAMES`). A call on constants
  only is a constant of the Program.

A Variable is a `torch.Tensor` subclass (its own `__torch_function__`
disabled, so an op on it gives a plain tensor that the recorder wraps);
a parameter of an `nn` layer stays the layer's `torch.nn.Parameter` and
is promoted into the Program (a slot, a name, a copy in the scope) the
first time a recorded op reads it.

`Executor.run` replays the op list with the feeds and the scope's
parameters. A Program with a loss and an optimizer (`Optimizer.
minimize`) trains: the parameters enter as leaf tensors,
`torch.autograd.grad` differentiates the replayed loss, the optimizer's
update rule writes the new values into the scope, and the fetches come
from the same replay, with the parameters from before the update (the
JAX step's order, `paddle_tpu/static/program.py:493-503`). The replay
runs on the Executor's place: the CUDA card unless the caller names the
CPU (`Executor(CPUPlace())`); where there is no card it raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..framework import monitor, static_hook
from ..framework.dtype import to_torch_dtype
from ..framework.place import resolve_device

__all__ = ["Program", "Executor", "program_guard", "default_main_program",
           "default_startup_program", "enable_static", "disable_static",
           "in_static_mode", "data", "scope_guard", "global_scope",
           "Variable", "append_backward", "make_parameter", "record_op",
           "apply_op"]


class _SlotCounter:
    """SSA slot allocator; advance_past() keeps fresh slots clear of ids
    preserved by a loaded Program (serde.program_from_doc)."""

    def __init__(self):
        self._n = 0

    def __next__(self):
        n = self._n
        self._n += 1
        return n

    def advance_past(self, n):
        self._n = max(self._n, n + 1)


_slot_counter = _SlotCounter()


class Variable(torch.Tensor):
    """A static-graph variable: a tensor holding a placeholder value (for
    shape and type propagation while the graph is built) plus an SSA
    slot used when the Program runs. Made by `data`, `make_parameter`
    and the recorder (`_new_var`), never by its constructor."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def name(self):
        return self.__dict__.get("_pt_name")

    @name.setter
    def name(self, value):
        self.__dict__["_pt_name"] = value


def _new_var(value, name=None, is_param=False, is_feed=False):
    with static_hook.suppressed():
        v = value.detach().as_subclass(Variable)
    v.slot = next(_slot_counter)
    v.name = name
    v.is_param = is_param
    v.is_feed = is_feed
    return v


def _slot_of(t):
    return getattr(t, "slot", None) if torch.is_tensor(t) else None


def _var_name(v):
    if isinstance(v, Variable):
        return v.name
    return getattr(v, "_pt_name", None)


def _is_param(t) -> bool:
    return isinstance(t, torch.nn.Parameter) or bool(
        getattr(t, "is_param", False))


def _live(t) -> bool:
    """A tensor the Program tracks: a Variable or an op output, or a
    layer's parameter read inside a module's forward (promoted when first
    read). Outside any forward a parameter is a constant: the ops of a
    model's construction and initialisation are not the Program's."""
    if not torch.is_tensor(t):
        return False
    if isinstance(t, torch.nn.Parameter):
        return _state.forward_depth > 0 or _state.params_live
    return _slot_of(t) is not None


class _Op:
    """One recorded op (the OpDesc analogue: reference
    `framework/op_desc.h:32` — type + attrs + input/output wiring)."""

    __slots__ = ("name", "fn", "in_refs", "out_slots", "attrs")

    def __init__(self, name, fn, in_refs, out_slots, attrs=None):
        self.name = name
        self.fn = fn
        self.in_refs = in_refs  # list of ("s", slot) | ("c", tensor)
        self.out_slots = out_slots
        self.attrs = attrs or {}

    @property
    def type(self):
        return self.name

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs[name]

    def all_attrs(self):
        return dict(self.attrs)

    @property
    def input_slots(self):
        return [ref for tag, ref in self.in_refs if tag == "s"]

    def __repr__(self):
        return f"_Op({self.name}: {self.input_slots} -> {self.out_slots})"


class Block:
    """reference `framework/block_desc.h:40`: an op list and a variable
    table, with parent nesting. Block 0 is the executed program; a
    control-flow op's sub-blocks hold its branches' ops, which the op
    replays (`run_ops`)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.ops: List[_Op] = []
        self.vars: Dict[int, torch.Tensor] = {}

    def var(self, name):
        for v in self.vars.values():
            if _var_name(v) == name:
                return v
        raise ValueError(f"no variable named {name!r} in block {self.idx}")

    def all_parameters(self):
        return self.program.all_parameters()

    @property
    def parent_block(self):
        return (self.program.blocks[self.parent_idx]
                if self.parent_idx >= 0 else None)

    def __repr__(self):
        return (f"Block(idx={self.idx}, parent={self.parent_idx}, "
                f"{len(self.ops)} ops)")


def _tensor_leaves(obj):
    return [x for x in pytree.tree_leaves(obj) if torch.is_tensor(x)]


class Program:
    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._cur_block_idx = 0
        self.feed_vars: Dict[str, Variable] = {}
        self.param_vars: Dict[str, torch.Tensor] = {}
        self._opt_hooks: List[Any] = []
        # bumped by program-rewriting passes so Executor caches keyed on
        # this program invalidate (quant_pass, static.amp)
        self._version = 0

    @property
    def ops(self) -> List[_Op]:
        return self.blocks[0].ops

    @ops.setter
    def ops(self, value):
        self.blocks[0].ops = value

    @property
    def vars(self) -> Dict[int, torch.Tensor]:
        return self.blocks[0].vars

    @vars.setter
    def vars(self, value):
        self.blocks[0].vars = value

    @property
    def num_blocks(self):
        return len(self.blocks)

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self._cur_block_idx]

    def _record_sub_block(self, fn, args=()):
        """Record `fn(*args)` into a fresh child Block.

        Returns (block_idx, external_vars, ret): the block index (the
        reference's sub_block attr), the enclosing blocks' Variables the
        branch reads or returns (the control-flow op takes them as
        explicit inputs, reference conditional_block's Input(X)), and
        what `fn` returned."""
        blk = Block(self, len(self.blocks), parent_idx=self._cur_block_idx)
        self.blocks.append(blk)
        prev = self._cur_block_idx
        self._cur_block_idx = blk.idx
        try:
            ret = fn(*args)
        finally:
            self._cur_block_idx = prev
        produced = {s for op in blk.ops for s in op.out_slots}
        ext: Dict[int, torch.Tensor] = {}
        for op in blk.ops:
            for tag, ref in op.in_refs:
                if tag == "s" and ref not in produced:
                    v = blk.vars.get(ref)
                    if v is None:
                        v = self._find_var(ref)
                    if v is not None:
                        ext[ref] = v
        for leaf in _tensor_leaves(ret):
            s = _slot_of(leaf)
            if s is not None and s not in produced:
                ext[s] = leaf
        return blk.idx, ext, ret

    def _find_var(self, slot):
        for b in self.blocks:
            if slot in b.vars:
                return b.vars[slot]
        return None

    def _promote(self, p):
        """Register parameter `p` in this Program (slot, name, a copy of
        its value in the scope) the first time an op of it reads `p`."""
        if _slot_of(p) is None:
            p.slot = next(_slot_counter)
        name = _var_name(p)
        if name is None:
            from ..utils import unique_name
            name = unique_name.generate("param")
            p._pt_name = name
        if self.param_vars.get(name) is not p:
            self.param_vars[name] = p
            self.blocks[0].vars[p.slot] = p
            if name not in _state.scope:
                with static_hook.suppressed():
                    _state.scope[name] = p.detach().clone()

    def record(self, name, fn, inputs, output_tensors, attrs=None):
        """Append one op: `inputs` are its tensor inputs in call order
        (slots for tracked tensors, constants for the rest)."""
        blk = self.current_block()
        in_refs = []
        for t in inputs:
            if isinstance(t, torch.nn.Parameter):
                self._promote(t)
                in_refs.append(("s", t.slot))
            elif _slot_of(t) is not None:
                in_refs.append(("s", t.slot))
                if t.slot not in self.blocks[0].vars:
                    blk.vars[t.slot] = t
            else:
                in_refs.append(("c", t))
        out_slots = [t.slot for t in output_tensors]
        for t in output_tensors:
            blk.vars[t.slot] = t
        blk.ops.append(_Op(name, fn, in_refs, out_slots, attrs))

    def clone(self, for_test=False):
        return self

    def global_block(self):
        return self.blocks[0]

    def all_parameters(self):
        return list(self.param_vars.values())

    def prune(self, targets):
        """Backward-slice the op list to what the target Variables need
        (reference `framework/prune.cc`). Returns a NEW Program sharing
        Variables but holding only the live ops."""
        targets = targets if isinstance(targets, (list, tuple)) else \
            [targets]
        live = {t.slot for t in targets}
        keep = []
        for op in reversed(self.ops):
            if any(s in live for s in op.out_slots):
                keep.append(op)
                for tag, ref in op.in_refs:
                    if tag == "s":
                        live.add(ref)
        keep.reverse()
        out = Program()
        out.ops = keep
        out.vars = dict(self.vars)
        out.feed_vars = {n: v for n, v in self.feed_vars.items()
                         if v.slot in live}
        out.param_vars = {n: v for n, v in self.param_vars.items()
                          if v.slot in live}
        out._opt_hooks = list(self._opt_hooks)
        # kept control-flow ops hold sub_block indices: carry every
        # sub-block so the indices stay resolvable
        for b in self.blocks[1:]:
            nb = Block(out, b.idx, b.parent_idx)
            nb.ops = list(b.ops)
            nb.vars = dict(b.vars)
            out.blocks.append(nb)
        return out

    # -- serialization (reference ProgramDesc.SerializeToString) ----------
    def to_doc(self, scope=None, include_params=True):
        from .serde import program_to_doc
        return program_to_doc(self, scope if scope is not None
                              else _state.scope, include_params)

    @classmethod
    def from_doc(cls, doc):
        from .serde import program_from_doc
        return program_from_doc(doc)

    def save(self, path, scope=None, include_params=True):
        from .serde import save_program
        save_program(self, path, scope, include_params)

    @classmethod
    def load(cls, path):
        from .serde import load_program
        return load_program(path)

    def __repr__(self):
        lines = [f"Program({len(self.ops)} ops)"]
        for op in self.ops[:50]:
            ins = [r if t == "s" else "const" for t, r in op.in_refs]
            lines.append(f"  {op.name}: {ins} -> {op.out_slots}")
        return "\n".join(lines)


class _StaticState(threading.local):
    def __init__(self):
        self.enabled = False
        self.mode = None
        self.main: Program = Program()
        self.startup: Program = Program()
        self.scope: Dict[str, torch.Tensor] = {}
        self.device_hint = None
        self.forward_depth = 0
        self.params_live = False
        self.hooks = []


_state = _StaticState()


# -- the recorder --------------------------------------------------------------

# torch names -> the JAX package's op names (its tensor_methods dunders
# and ops); anything else keeps torch's name without underscores
_TORCH_NAMES = {
    "add": "add", "radd": "add", "sub": "subtract", "rsub": "subtract",
    "subtract": "subtract", "mul": "multiply", "rmul": "multiply",
    "multiply": "multiply", "truediv": "divide", "rtruediv": "divide",
    "div": "divide", "divide": "divide", "floordiv": "floor_divide",
    "rfloordiv": "floor_divide", "mod": "mod", "pow": "pow",
    "rpow": "pow", "matmul": "matmul", "rmatmul": "matmul",
    "neg": "neg", "abs": "abs", "invert": "bitwise_not",
    "and": "bitwise_and", "or": "bitwise_or", "xor": "bitwise_xor",
    "eq": "equal", "ne": "not_equal", "lt": "less_than",
    "le": "less_equal", "gt": "greater_than", "ge": "greater_equal",
    "getitem": "getitem", "setitem": "setitem", "cat": "concat",
    "concat": "concat", "view": "reshape", "reshape": "reshape",
    "permute": "transpose", "transpose": "transpose", "mean": "reduce_mean",
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    "prod": "reduce_prod", "to": "cast", "type": "cast", "float": "cast",
    "unsqueeze": "unsqueeze", "squeeze": "squeeze", "expand": "expand",
    "split": "split", "chunk": "split", "stack": "stack", "where": "where",
    "clamp": "clip", "clip": "clip", "flatten": "flatten",
}


def _torch_name(func) -> str:
    n = getattr(func, "__name__", None) or type(func).__name__
    if n == "__get__":   # a property read (`x.T`)
        n = getattr(getattr(func, "__self__", None), "__name__", "getattr")
    n = n.strip("_")
    if n.startswith("i") and n[1:] in ("add", "sub", "mul", "truediv"):
        n = n[1:]        # __iadd__ and the like: recorded as the op
    return _TORCH_NAMES.get(n, n)


def _is_inplace(func) -> bool:
    n = getattr(func, "__name__", "")
    if n in ("__setitem__", "__iadd__", "__isub__", "__imul__",
             "__itruediv__", "__ior__", "__iand__"):
        return True
    return n.endswith("_") and not n.endswith("__")


def _record_call(fn, args, kwargs, name=None, torch_fn=False):
    """Run `fn(*args, **kwargs)` on the placeholders and record it as one
    op of the current Program when any of its tensor inputs is tracked;
    return its outputs, each tensor a new Variable."""
    kwargs = kwargs or {}
    leaves, spec = pytree.tree_flatten((args, kwargs))
    t_pos = [i for i, l in enumerate(leaves) if torch.is_tensor(l)]
    if not any(_live(leaves[i]) for i in t_pos):
        with static_hook.suppressed():
            return fn(*args, **kwargs)
    inplace = torch_fn and _is_inplace(fn) and bool(t_pos) \
        and t_pos[0] == 0 and not _is_param(leaves[0])
    # a parameter read outside a forward enters as a constant
    inputs = [leaves[i] if _live(leaves[i]) or not isinstance(
        leaves[i], torch.nn.Parameter) else leaves[i].detach()
        for i in t_pos]
    if inplace and _slot_of(inputs[0]) is None:
        inputs[0] = inputs[0].detach().clone()   # the value before the op
    static_hook._state.announced = None
    with static_hook.suppressed(), torch.no_grad():
        out = fn(*args, **kwargs)
    name = name or static_hook._state.announced or (
        _torch_name(fn) if torch_fn else getattr(fn, "__name__", "op"))
    out_leaves, out_spec = pytree.tree_flatten(out)
    if inplace:
        o_pos = []
    else:
        o_pos = [i for i, o in enumerate(out_leaves) if torch.is_tensor(o)
                 and not any(o is l for l in leaves)]
        if not o_pos:
            return out   # no new tensor: a query, or an identity

    def op_fn(*vals, _leaves=tuple(leaves), _t_pos=tuple(t_pos),
              _spec=spec, _fn=fn, _o_pos=tuple(o_pos), _inplace=inplace):
        ls = list(_leaves)
        for i, v in zip(_t_pos, vals):
            ls[i] = v
        if _inplace:
            ls[0] = ls[0].clone()
        a, k = pytree.tree_unflatten(ls, _spec)
        res = _fn(*a, **k)
        if _inplace:
            return (ls[0],)
        rl = pytree.tree_leaves(res)
        return tuple(rl[i] for i in _o_pos)

    attrs = {}
    if not torch_fn:
        # the op's plain non-tensor arguments, inspectable as OpDesc attrs
        simple = (bool, int, float, str, type(None))
        attrs = {f"arg{i}": a for i, a in enumerate(args)
                 if isinstance(a, simple)}
        attrs.update((k, v) for k, v in kwargs.items()
                     if isinstance(v, simple))
    if inplace:
        target = leaves[0]
        new = _new_var(target)
        record_op(name, op_fn, inputs, [new], attrs)
        target.slot = new.slot   # the mutated tensor now names the result
        _state.main.current_block().vars[new.slot] = target
        return out
    outs = []
    for i in o_pos:
        v = _new_var(out_leaves[i])
        out_leaves[i] = v
        outs.append(v)
    record_op(name, op_fn, inputs, outs, attrs)
    return pytree.tree_unflatten(out_leaves, out_spec)


class _Recorder(TorchFunctionMode):
    """Records the torch calls made while static mode is on (outside a
    named op and outside a replay). Inside its handler the mode is off,
    so a call is recorded once, not its parts."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if static_hook._state.depth or not _state.enabled:
            return func(*args, **kwargs)
        return _record_call(func, args, kwargs, torch_fn=True)


def apply_op(name, fn, args, attrs=None):
    """`fn(*args)` as one op named `name`: recorded while static mode is
    on, run directly otherwise (the JAX package's `apply_op` for the
    static layers' own ops)."""
    if not static_hook.recording():
        return fn(*args)
    prev, _state.params_live = _state.params_live, True
    try:
        out = _record_call(fn, tuple(args), {}, name)
    finally:
        _state.params_live = prev
    if attrs:
        _state.main.current_block().ops[-1].attrs.update(attrs)
    return out


# -- mode, programs, scope -------------------------------------------------------

def in_static_mode() -> bool:
    return _state.enabled


def _enter_forward(module, args):
    _state.forward_depth += 1


def _leave_forward(module, args, out):
    _state.forward_depth -= 1


def enable_static():
    if _state.enabled:
        return
    _state.enabled = True
    _state.forward_depth = 0
    _state.hooks = [
        torch.nn.modules.module.register_module_forward_pre_hook(
            _enter_forward),
        torch.nn.modules.module.register_module_forward_hook(
            _leave_forward, always_call=True)]
    _state.mode = _Recorder()
    _state.mode.__enter__()
    static_hook.install(_record_call)


def disable_static(place=None):
    if not _state.enabled:
        return
    _state.enabled = False
    static_hook.uninstall()
    for h in _state.hooks:
        h.remove()
    _state.hooks = []
    mode, _state.mode = _state.mode, None
    mode.__exit__(None, None, None)


@contextlib.contextmanager
def recorder_paused():
    """Take the recorder's mode off the thread's mode stack while a
    Program replays: a TorchFunctionMode costs every torch call made from
    Python a trip through its handler, which a replay (the forward's
    named ops, autograd's Python functions, the optimizer's update) does
    not need."""
    mode = _state.mode
    if mode is None or torch.overrides._get_current_function_mode() \
            is not mode:
        yield
        return
    mode.__exit__(None, None, None)
    try:
        yield
    finally:
        mode.__enter__()


def default_main_program() -> Program:
    return _state.main


def default_startup_program() -> Program:
    return _state.startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_m, prev_s = _state.main, _state.startup
    _state.main = main_program
    if startup_program is not None:
        _state.startup = startup_program
    try:
        yield
    finally:
        _state.main, _state.startup = prev_m, prev_s


def global_scope():
    return _state.scope


@contextlib.contextmanager
def scope_guard(scope):
    prev = _state.scope
    _state.scope = scope
    try:
        yield
    finally:
        _state.scope = prev


def data(name, shape, dtype="float32", lod_level=0):
    """A feed Variable of the default main program, its placeholder zeros
    on the default place; None/-1 dims are 1 in the placeholder."""
    shape = [1 if (s is None or s == -1) else int(s) for s in shape]
    with static_hook.suppressed():
        value = torch.zeros(shape, dtype=to_torch_dtype(dtype),
                            device=resolve_device(None))
    v = _new_var(value, name=name, is_feed=True)
    _state.main.feed_vars[name] = v
    _state.main.vars[v.slot] = v
    return v


def make_parameter(name, value):
    """Register a parameter Variable `name` holding `value` in the
    default main program and the scope; returns the Variable."""
    with static_hook.suppressed():
        value = torch.as_tensor(value, device=resolve_device(None)) \
            if not torch.is_tensor(value) else value
        v = _new_var(value, name=name, is_param=True)
        _state.scope[name] = value.detach().clone()
    _state.main.param_vars[name] = v
    _state.main.vars[v.slot] = v
    return v


def record_op(name, fn, inputs, outputs, attrs=None):
    hint = _state.device_hint
    if hint is not None:
        attrs = dict(attrs or {})
        attrs["op_device"] = hint   # reference device_guard attr name
    _state.main.record(name, fn, inputs, outputs, attrs)


# -- replay ------------------------------------------------------------------------

def run_ops(program, ops, env, device=None):
    """Replay `ops` into `env` (slot -> tensor); a slot missing from
    `env` reads the Variable's placeholder, a constant moves to
    `device`."""
    for op in ops:
        args = []
        for tag, ref in op.in_refs:
            if tag == "c":
                v = ref
                if device is not None and torch.is_tensor(v) and \
                        v.device != device:
                    v = v.to(device)
            elif ref in env:
                v = env[ref]
            else:
                v = program._find_var(ref)
            args.append(v)
        outs = op.fn(*args)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        for s, o in zip(op.out_slots, outs):
            env[s] = o
    return env


class _Lowered:
    """A program as one function (feeds, params) -> fetches."""

    def __init__(self, program: Program, fetch_slots: Sequence[int],
                 device=None):
        self.program = program
        self.fetch_slots = list(fetch_slots)
        self.device = device
        feed_items = sorted(program.feed_vars.items())
        self.feed_names = [n for n, _ in feed_items]
        self.feed_slots = [v.slot for _, v in feed_items]
        param_items = sorted(program.param_vars.items())
        self.param_names = [n for n, _ in param_items]
        self.param_slots = [v.slot for _, v in param_items]

    def env(self, feed_list, param_list):
        env: Dict[int, Any] = {}
        env.update(zip(self.feed_slots, feed_list))
        env.update(zip(self.param_slots, param_list))
        with static_hook.suppressed():
            return run_ops(self.program, self.program.ops, env, self.device)

    def fetch(self, env, slots=None):
        return [env[s] if s in env else self.program._find_var(s)
                for s in (self.fetch_slots if slots is None else slots)]

    def __call__(self, feed_list, param_list):
        return self.fetch(self.env(feed_list, param_list))


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Marks the program for gradient computation (reference
    `fluid/backward.py:1337`); `Executor.run` differentiates the replayed
    loss with `torch.autograd.grad`."""
    prog = _state.main
    prog._loss_slot = loss.slot
    params = parameter_list or list(prog.param_vars.values())
    return [(p, None) for p in params]


def _as_feed(arr, device):
    if torch.is_tensor(arr):
        return arr.detach().to(device)
    return torch.as_tensor(np.asarray(arr)).to(device)


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """reference `fluid/executor.py:916`: runs Programs on one place, the
    CUDA card unless `place` names the CPU (raises where the card is
    asked for and there is none). One prepared replay per (program,
    fetch) key, as the JAX package caches one jit."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: Dict[Any, _Lowered] = {}

    def _feeds(self, program, feed):
        out = []
        for n in sorted(program.feed_vars):
            if n in feed:
                out.append(_as_feed(feed[n], self.device))
            else:
                out.append(program.feed_vars[n].to(self.device))
        return out

    def run(self, program=None, feed=None, fetch_list=None,
            scope=None, return_numpy=True, use_program_cache=True):
        monitor.stat_add("STAT_executor_runs")
        program = program or _state.main
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope if scope is not None else _state.scope

        if program is _state.startup or not fetch_list and not feed:
            # startup program: parameters were made at build time;
            # only its own ops run
            if program.ops:
                self._run_plain(program, scope)
            return []

        fetch_slots = [f.slot for f in fetch_list]
        train = bool(hasattr(program, "_loss_slot") and program._opt_hooks)
        feeds = self._feeds(program, feed)
        key = (id(program), getattr(program, "_version", 0),
               tuple(fetch_slots),
               tuple((tuple(a.shape), str(a.dtype)) for a in feeds),
               train, len(program.ops))
        lowered = self._cache.get(key)
        if lowered is None:
            lowered = self._cache[key] = _Lowered(program, fetch_slots,
                                                  self.device)
        params = [scope[n].to(self.device) for n in lowered.param_names]
        with recorder_paused():
            if train:
                outs = self._train_step(program, lowered, feeds, params,
                                        scope)
            else:
                with torch.no_grad():
                    outs = lowered(feeds, params)
        if return_numpy:
            return [_host(o) for o in outs]
        return [o.detach() for o in outs]

    def _train_step(self, program, lowered, feeds, params, scope):
        """One step: the replayed loss differentiated, the registered
        optimizer's `_apply` on the gradients, with its state kept on the
        Program by parameter name; returns the fetches of the same replay
        (the parameters from before the update)."""
        opt = program._opt_hooks[-1]
        leaves = [p.detach().requires_grad_(p.is_floating_point())
                  for p in params]
        with torch.enable_grad():
            env = lowered.env(feeds, leaves)
            loss = env[program._loss_slot]
            diff = [i for i, p in enumerate(leaves) if p.requires_grad]
            grads = torch.autograd.grad(
                loss, [leaves[i] for i in diff], allow_unused=True)
        outs = lowered.fetch(env)
        grads = [g if g is not None else torch.zeros_like(leaves[i])
                 for i, g in zip(diff, grads)]
        names = [lowered.param_names[i] for i in diff]
        if not hasattr(program, "_opt_state"):
            program._opt_state = {}
            program._step_no = 0
        step_no = program._step_no + 1
        new_ps, new_states = opt._apply(
            grads, [leaves[i].detach() for i in diff],
            [program._opt_state.get(n) for n in names], step_no)
        for n, p, st in zip(names, new_ps, new_states):
            scope[n] = p
            program._opt_state[n] = st
        program._step_no = step_no
        return outs

    def train_from_dataset(self, program, dataset, fetch_list=None,
                           fetch_info=None, print_period=100, debug=False):
        """reference `framework/trainer.h` MultiTrainer /
        `executor.cc:152` RunFromDataset: drive the program from any
        iterable of batches, each a sequence in sorted feed-name order
        or a dict by feed name."""
        feed_names = sorted(program.feed_vars.keys())
        results = []
        for step, batch in enumerate(dataset):
            feed = batch if isinstance(batch, dict) else \
                {n: b for n, b in zip(feed_names, batch)}
            out = self.run(program, feed=feed, fetch_list=fetch_list or [])
            if fetch_list:
                results.append(out)
            if debug and step % print_period == 0:
                print(f"[train_from_dataset] step {step}: {out}")
        return results

    def infer_from_dataset(self, program, dataset, fetch_list=None, **kw):
        return self.train_from_dataset(program, dataset, fetch_list, **kw)

    def _run_plain(self, program, scope):
        lowered = _Lowered(program, [], self.device)
        feeds = [program.feed_vars[n].to(self.device)
                 for n in lowered.feed_names]
        params = [scope.get(n, program.param_vars[n]).to(self.device)
                  for n in lowered.param_names]
        with recorder_paused(), torch.no_grad():
            lowered.env(feeds, params)

    def close(self):
        pass
