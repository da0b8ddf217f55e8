"""`to_static` and `jit.save` / `jit.load` (port of `paddle_tpu.jit`;
reference `fluid/dygraph/jit.py:160,507,787`).

- `to_static(fn_or_layer, input_spec=)` keeps the input spec that `save`
  reads and rewrites the function's (the layer's `forward`'s) Python
  control flow through `dy2static` (`ast_transform`), as the JAX
  package's `to_static` does (`paddle_tpu/jit/__init__.py:60-61`): run
  eagerly, a branch on a concrete tensor is plain Python; traced by
  `torch.export` (`save`), a tensor-valued `if` becomes `torch.cond` and
  a tensor-valued `while` `torch._higher_order_ops.while_loop`; under a
  static `program_guard` they record `cond` / `while` ops.
- `save(layer, path, input_spec=)` writes `{path}.pdmodel`, a
  `torch.export` program of the layer in eval mode (`torch.export.save`),
  `{path}.pdiparams`, the layer's state (`torch.save` of CPU tensors),
  and `{path}.pdmeta`, the manifest (input dims and types; the quant
  manifest). `None`/-1 dims stay symbolic (`static.export_inputs`: one
  shared batch dim, per-input names for the rest), so one artifact
  serves any batch. A program that refuses symbolic dims raises; a
  fixed-shape artifact is asked for with a concrete `InputSpec`.
- Weight-only-quantized layers (`quantization.WeightOnlyLinear`, found
  through `quant_weight_spec()`): their integer weights and scales are
  leading runtime arguments of the program, never program constants, so
  the `.pdmodel` holds no integer weight and no float copy of one is made
  (`_collect_quant`, the JAX package's `:246-273`, `:296-330`).
- `load(path, device=None)` -> `TranslatedLayer` on the CUDA card
  (raising where there is none); `device="cpu"` asks for the CPU.
  Importing this module imports
  `ops.flash_ops`, which registers `paddle_tpu_torch::flash_fwd` (K2), so
  a program that holds the op loads; the op's dispatch picks K2 or its
  plain version from the tensors' device when the program runs.
  `TranslatedLayer` places the program on a device with
  `torch.export.passes.move_to_device_pass`: an export on the CPU
  records literal devices (ERNIE's `torch.arange(device=...)`, the flash
  entry's mask-to-bias constants) that the pass rewrites.

The serving program store's helpers (`serialize_compiled` and after,
the JAX package's `:437-501`): its artifact is a `torch.export`
`ExportedProgram` saved to bytes with `torch.export.save`. The program is
never put through `run_decompositions()`, which functionalizes its pool
writes into whole-pool copies, so `compiled_alias_spec` reads what it
writes in place off the graph's in-place ops, not off its signature.
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Callable, Dict

import torch
from torch import nn

from ..framework import monitor
from ..framework.place import resolve_device
from ..ops import flash_ops  # noqa: F401 — registers paddle_tpu_torch::flash_fwd
from ..static.input_spec import export_inputs
from . import dy2static  # noqa: F401
from .dy2static import ProgramTranslator, ast_transform, enable_to_static

__all__ = ["to_static", "declarative", "not_to_static", "save", "load",
           "load_meta", "TranslatedLayer", "StaticFunction",
           "ProgramTranslator", "enable_to_static", "dy2static",
           "serialize_compiled", "deserialize_compiled",
           "compiled_alias_spec", "pytree_spec", "key_material_digest"]


class StaticFunction:
    """A function decorated by `to_static`: its control flow rewritten by
    `dy2static`, run eagerly; keeps its input spec."""

    def __init__(self, function: Callable, input_spec=None):
        self._function = ast_transform(function)
        self._input_spec = input_spec

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return StaticFunction(self._function.__get__(instance, owner),
                              self._input_spec)

    def __call__(self, *args, **kwargs):
        return self._function(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None):
    """Mark a function or layer for export. A layer keeps `input_spec`
    (read by `save` when it is given none) and its `forward` is replaced
    by the `dy2static` rewrite of it."""
    def decorate(fn):
        if isinstance(fn, nn.Module):
            fn._to_static_spec = input_spec
            fwd = ast_transform(fn.forward)
            if fwd is not fn.forward:
                fn.forward = fwd
            return fn
        return StaticFunction(fn, input_spec)
    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    fn._not_to_static = True
    return fn


# -- save ----------------------------------------------------------------------

def _collect_quant(layer):
    """Quant manifest for `save`: every submodule exposing
    `quant_weight_spec()` contributes its quantized-weight and scale
    buffer names, each once (a tied layer appears under its first name,
    as `named_modules` dedups). These tensors become leading runtime
    arguments of the exported program instead of program constants, so
    the artifact stays integer-weighted and small."""
    args, entries, seen = [], [], set()
    for pfx, sub in layer.named_modules():
        spec = getattr(sub, "quant_weight_spec", None)
        if spec is None or id(sub) in seen:
            continue
        seen.add(id(sub))
        for qattr, sattr, bits in spec():
            qname = f"{pfx}.{qattr}" if pfx else qattr
            sname = f"{pfx}.{sattr}" if pfx else sattr
            args += [qname, sname]
            entries.append({"name": qname, "scale": sname,
                            "bits": int(bits)})
    return {"version": 1, "args": args, "entries": entries} \
        if entries else None


class _QuantArgs(nn.Module):
    """Export wrapper of a quantized layer: forward(*qvals, *xs) runs the
    layer with its quantized buffers replaced by the leading arguments
    (`torch.func.functional_call`)."""

    def __init__(self, layer, qnames):
        super().__init__()
        self.layer = layer
        self.qnames = list(qnames)

    def forward(self, *args):
        n = len(self.qnames)
        return torch.func.functional_call(
            self.layer, dict(zip(self.qnames, args[:n])), tuple(args[n:]))


def _swap_buffers(layer, names, tensors):
    """Set each named buffer of `layer` to the given tensor; returns the
    tensors replaced."""
    old = []
    for name, t in zip(names, tensors):
        mod_name, _, attr = name.rpartition(".")
        mod = layer.get_submodule(mod_name) if mod_name else layer
        old.append(mod._buffers[attr])
        mod._buffers[attr] = t
    return old


def _export(module, examples, shapes):
    dyn = None
    if any(s for s in shapes):
        # _QuantArgs takes *args: its inputs are one tuple
        dyn = ((tuple(shapes),) if isinstance(module, _QuantArgs)
               else tuple(shapes))
    with torch.no_grad():
        return torch.export.export(module, tuple(examples),
                                   dynamic_shapes=dyn)


def save(layer, path, input_spec=None, **configs):
    """reference `jit.py:507`: writes {path}.pdmodel, {path}.pdiparams and
    {path}.pdmeta (see the module docstring). The layer is exported in
    eval mode and put back in its own mode after."""
    if not isinstance(layer, nn.Module):
        raise TypeError("jit.save expects an nn.Layer")
    if input_spec is None:
        input_spec = getattr(layer, "_to_static_spec", None)
    if input_spec is None:
        raise ValueError("jit.save requires input_spec")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    p0 = next(iter(layer.parameters()), None)
    if p0 is None:   # a module of buffers only (a static Program's)
        p0 = next(iter(layer.buffers()), None)
    device = p0.device if p0 is not None else torch.device("cpu")
    quant = _collect_quant(layer)
    state = layer.state_dict()
    was_training = layer.training
    layer.eval()
    try:
        module, qvals, old = layer, [], None
        if quant is not None:
            monitor.stat_add("STAT_quant_exports")
            qnames = quant["args"]
            qvals = [state[n] for n in qnames]
            module = _QuantArgs(layer, qnames)
            # the program must not hold the integer weights as its own
            # state: empty placeholders stand in while it is traced
            old = _swap_buffers(layer, qnames, [
                torch.empty(0, dtype=v.dtype, device=v.device)
                for v in qvals])
        try:
            xs, shapes, dims = export_inputs(input_spec, device)
            exported = _export(module, qvals + xs,
                               [None] * len(qvals) + shapes)
        finally:
            if old is not None:
                _swap_buffers(layer, quant["args"], old)
    finally:
        layer.train(was_training)
    # through file objects: torch.export's archive names want ".pt2"
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(exported, f)
    torch.save({n: t.detach().cpu() for n, t in state.items()},
               path + ".pdiparams")
    meta = {"input_specs": [
        (d, str(x.dtype).replace("torch.", "")) for d, x in zip(dims, xs)]}
    if quant is not None:
        meta["quant"] = quant
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f, protocol=4)


# -- load ----------------------------------------------------------------------

class TranslatedLayer:
    """reference `jit.py:787` TranslatedLayer: runs a saved program.

    `program(device)` is the program placed on `device` (moved once per
    device and kept); calling the layer runs it on the layer's device,
    with its inputs moved there. A quantized artifact's integer weights
    and scales (its `.pdmeta` "quant" manifest) are placed once on that
    device, counted in STAT_quant_weight_hbm_bytes while the layer
    lives, and prepended to every call."""

    def __init__(self, exported, state, quant=None, device=None):
        self._exported = exported
        self._state = state
        self._quant = quant
        self._device = resolve_device(device)
        self._programs: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self.training = False
        self._qargs = []
        if quant:
            missing = [n for n in quant["args"] if n not in state]
            if missing:
                raise ValueError(
                    f"quantized artifact is missing weight tensors "
                    f"{missing} in its params file")
            self._qargs = [state[n].to(self._device)
                           for n in quant["args"]]
            from ..inference import quant_resident
            quant_resident(self, self._qargs)

    @property
    def device(self) -> torch.device:
        return self._device

    def program(self, device) -> Callable:
        """The program as a module on `device` (its state copied there by
        `move_to_device_pass`, once per device)."""
        key = str(torch.device(device))
        with self._lock:
            fn = self._programs.get(key)
            if fn is None:
                from torch.export.passes import move_to_device_pass
                fn = move_to_device_pass(self._exported, key).module()
                self._programs[key] = fn
        return fn

    def user_inputs(self):
        """[(dims, torch dtype)] of the program's caller inputs (after the
        quantized weights): a symbolic dim is None."""
        sig = self._exported.graph_signature
        names = list(sig.user_inputs)[len(self._qargs):]
        nodes = {n.name: n for n in self._exported.graph.nodes
                 if n.op == "placeholder"}
        out = []
        for name in names:
            val = nodes[name].meta["val"]
            out.append((tuple(int(d) if isinstance(d, int) else None
                              for d in val.shape), val.dtype))
        return out

    def __call__(self, *args):
        xs = [torch.as_tensor(a).to(self._device) for a in args]
        with torch.no_grad():
            return self.program(self._device)(*self._qargs, *xs)

    forward = __call__

    def eval(self):
        self.training = False
        return self

    def state_dict(self):
        return dict(self._state)


def load_meta(path) -> dict:
    """The .pdmeta sidecar ({} when absent)."""
    if not os.path.exists(path + ".pdmeta"):
        return {}
    with open(path + ".pdmeta", "rb") as f:
        return pickle.load(f)


def load(path, device=None, **configs) -> TranslatedLayer:
    """Load `{path}.pdmodel` (and its params and manifest) as a
    TranslatedLayer that runs on `device`: the CUDA card by default
    (raising where there is none), the CPU when `device="cpu"`."""
    with open(path + ".pdmodel", "rb") as f:
        exported = torch.export.load(f)
    state = {}
    if os.path.exists(path + ".pdiparams"):
        state = torch.load(path + ".pdiparams", weights_only=True)
    return TranslatedLayer(exported, state,
                           quant=load_meta(path).get("quant"),
                           device=device)


# -- the serving program store's artifact -----------------------------------
#
# `serving/program_store.py` keeps the engine's programs across processes
# as `torch.export` programs. A program writes the KV pools it is handed
# in place; a loaded program is trusted only while it still does, so what
# it writes is read off its graph here and checked on every load.

def serialize_compiled(program) -> bytes:
    """`torch.export.save` of an `ExportedProgram`, to bytes. The example
    inputs are dropped first (a serving program's inputs are its weights
    and pools), so the bytes hold the graph alone."""
    import io
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def deserialize_compiled(blob: bytes):
    """Inverse of `serialize_compiled`: the `ExportedProgram` (call it
    through `.module()`). Raises on bytes that are not one."""
    import io
    return torch.export.load(io.BytesIO(blob))


def _written_input(node):
    """The placeholder a mutated argument `node` is a view chain of
    (select, slice, view, ... back to an input), or None."""
    while isinstance(node, torch.fx.Node):
        if node.op == "placeholder":
            return node
        schema = getattr(node.target, "_schema", None)
        if (node.op != "call_function" or schema is None
                or not schema.arguments
                or schema.arguments[0].alias_info is None):
            return None
        node = node.args[0]
    return None


def compiled_alias_spec(program) -> str:
    """The user inputs `program` writes in place, as a canonical string:
    "<position>:<name>" of each, by input position, comma-separated; ""
    for a program that writes none. Read off the graph: each op whose
    schema marks an argument as written, traced through its views back
    to a placeholder. The signature's `user_inputs_to_mutate` is empty
    for such a program, so it cannot say this; a program put through
    `run_decompositions()` writes whole copies instead and reads "" here
    (the corruption class the store's self-check refuses)."""
    users = list(program.graph_signature.user_inputs)
    position = {n: i for i, n in enumerate(users)}
    written = set()
    for node in program.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op != "call_function" or schema is None:
            continue
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            src = (node.args[i] if i < len(node.args)
                   else node.kwargs.get(arg.name))
            base = _written_input(src)
            if base is not None and base.name in position:
                written.add((position[base.name], base.name))
    return ", ".join(f"{i}:{n}" for i, n in sorted(written))


def _tree_leaves(tree, path=""):
    """(keystr path, leaf) pairs in the JAX package's flattening order:
    dict keys sorted, list and tuple items by index, None no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _tree_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _tree_leaves(t, f"{path}[{i}]")]
    return [(path, tree)]


def pytree_spec(tree) -> list:
    """Structural fingerprint of a nested dict / list / tuple of arrays
    (torch tensors or numpy): sorted [path, shape, dtype] triples, dtypes
    spelled as numpy spells them ("float32"). For a quantized
    decode-weight tree the (int8, scale) leaf pairs land here with their
    own types and shapes, so the program store's key tells quantized
    weights apart."""
    import numpy as np
    out = []
    for path, leaf in _tree_leaves(tree):
        arr = leaf if hasattr(leaf, "dtype") else np.asarray(leaf)
        out.append([path, [int(d) for d in getattr(arr, "shape", [])],
                    str(arr.dtype).replace("torch.", "")])
    return sorted(out)


def key_material_digest(material) -> str:
    """Stable content key over JSON-able key material (the program
    store's directory name): canonical JSON, blake2b-128 hex. A non-JSON
    leaf falls back to str()."""
    import hashlib
    import json
    blob = json.dumps(material, sort_keys=True, separators=(",", ":"),
                      default=str).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()
