"""Program IR serialization (port of `paddle_tpu.static.serde`;
reference ProgramDesc ⊃ BlockDesc ⊃ OpDesc protobuf,
`paddle/fluid/framework/framework.proto:43-207`, and `fluid/io.py:1199`
save/load_inference_model).

The op-level document is JSON: one entry per recorded op with its type
name, inspectable attrs, SSA slot wiring and the variables' shapes and
types, as the JAX package's. Each op's computation is a `torch.export`
program of its callable over its inputs' shapes and types
(`torch.export.save`, base64 in the document), where the JAX package
stores StableHLO exported with `vjp_order=1`. A loaded op runs the
program's module, which autograd differentiates op by op, so a loaded
Program trains; the `sdpa` op exports as a `paddle_tpu_torch::flash_fwd`
node, whose registered autograd formula runs K3/K4 (their plain versions
on the CPU). A loaded op places its program on the device of its first
tensor input, once per device (`move_to_device_pass`). The document
round-trips across processes: save -> new interpreter -> load ->
identical outputs.
"""
from __future__ import annotations

import base64
import io
import json
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..framework import static_hook
from ..framework.dtype import to_torch_dtype

__all__ = ["save_program", "load_program", "program_to_doc",
           "program_from_doc"]

_VERSION = 1


def _tensor_b64(t) -> Dict[str, str]:
    buf = io.BytesIO()
    torch.save(t.detach().cpu().clone(), buf)
    return {"pt_b64": base64.b64encode(buf.getvalue()).decode("ascii")}


def _tensor_unb64(doc, device=None) -> torch.Tensor:
    t = torch.load(io.BytesIO(base64.b64decode(doc["pt_b64"])),
                   weights_only=True)
    return t if device is None else t.to(device)


def _json_safe_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in (attrs or {}).items():
        if isinstance(v, (bool, int, float, str, type(None))):
            out[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (bool, int, float, str)) for x in v):
            out[k] = list(v)
        else:
            out[k] = repr(v)
    return out


class _OpModule(torch.nn.Module):
    """An op's callable as a module for `torch.export`: flat tensors in,
    a tuple of tensors out."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        with static_hook.suppressed():
            out = self.fn(*args)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _plain(t):
    return t.detach().as_subclass(torch.Tensor)


def propagate(program) -> Dict[int, torch.Tensor]:
    """slot -> the value it holds when block 0 replays on the feeds' and
    parameters' placeholders: the shapes and types the ops meet at run
    time, which a rewriting pass (static.amp's casts) may have changed
    since the ops were recorded."""
    from .program import run_ops
    env = {v.slot: _plain(v) for v in list(program.feed_vars.values())
           + list(program.param_vars.values())}
    with static_hook.suppressed(), torch.no_grad():
        return run_ops(program, program.ops, env)


def export_op(op, program, values) -> bytes:
    """The bytes of a `torch.export` program of `op.fn` over its inputs'
    values (`propagate`'s; a slot no op of block 0 makes, its
    placeholder); the example inputs are not kept in it."""
    examples = [_plain(ref if tag == "c" else values[ref] if ref in values
                       else program._find_var(ref))
                for tag, ref in op.in_refs]
    with static_hook.suppressed():
        ep = torch.export.export(_OpModule(op.fn), tuple(examples))
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


class _LoadedOp:
    """A loaded op's callable: the exported program as a module on the
    device of its first tensor argument."""

    def __init__(self, blob: bytes):
        self._ep = torch.export.load(io.BytesIO(blob))
        self._mods: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _module(self, device):
        key = str(device)
        with self._lock:
            mod = self._mods.get(key)
            if mod is None:
                from torch.export.passes import move_to_device_pass
                mod = move_to_device_pass(self._ep, key).module()
                self._mods[key] = mod
        return mod

    def __call__(self, *args):
        dev = next((a.device for a in args if torch.is_tensor(a)),
                   torch.device("cpu"))
        from .program import Variable
        args = [_plain(a) if isinstance(a, Variable) else a for a in args]
        return tuple(self._module(dev)(*args))


def program_to_doc(program, scope: Optional[Dict[str, torch.Tensor]] = None,
                   include_params: bool = True) -> Dict[str, Any]:
    """Program -> JSON-serializable document (OpDesc-level
    inspectable)."""
    from .program import recorder_paused
    with recorder_paused():
        return _program_to_doc(program, scope, include_params)


def _program_to_doc(program, scope, include_params):
    from .program import _var_name
    var_docs = {}
    values = propagate(program)

    def note_var(slot):
        if slot in var_docs:
            return
        var = program._find_var(slot)
        v = values.get(slot, var)
        var_docs[slot] = {
            "name": _var_name(var),
            "shape": list(v.shape),
            "dtype": str(v.dtype).replace("torch.", ""),
            "is_param": bool(getattr(var, "is_param", False)
                             or isinstance(var, torch.nn.Parameter)),
            "is_feed": bool(getattr(var, "is_feed", False)),
        }

    # feeds/params must survive even when no recorded op consumes them yet
    for v in list(program.feed_vars.values()) + \
            list(program.param_vars.values()):
        note_var(v.slot)

    ops = []
    for op in program.ops:
        in_docs = []
        for tag, ref in op.in_refs:
            if tag == "s":
                note_var(ref)
                in_docs.append(["s", ref])
            else:
                in_docs.append(["c", _tensor_b64(ref)])
        for s in op.out_slots:
            note_var(s)
        ops.append({
            "type": op.name,
            "attrs": _json_safe_attrs(getattr(op, "attrs", None)),
            "inputs": in_docs,
            "outputs": list(op.out_slots),
            "export_b64": base64.b64encode(
                export_op(op, program, values)).decode("ascii"),
        })

    doc = {
        "version": _VERSION,
        "ops": ops,
        "vars": {str(s): d for s, d in var_docs.items()},
        "feed_vars": {n: v.slot for n, v in program.feed_vars.items()},
        "param_vars": {n: v.slot for n, v in program.param_vars.items()},
    }
    # control-flow sub-blocks (reference BlockDesc nesting): a structural
    # mirror; block 0's control-flow op program already holds the
    # branches
    if program.num_blocks > 1:
        doc["blocks"] = [{
            "idx": b.idx,
            "parent_idx": b.parent_idx,
            "ops": [{
                "type": op.name,
                "attrs": _json_safe_attrs(op.attrs),
                "inputs": [["s", ref] if tag == "s" else
                           ["c", _tensor_b64(ref)] for tag, ref in
                           op.in_refs],
                "outputs": list(op.out_slots),
            } for op in b.ops],
        } for b in program.blocks[1:]]
    if hasattr(program, "_loss_slot"):
        doc["loss_slot"] = program._loss_slot
    if include_params and scope is not None:
        doc["params"] = {n: _tensor_b64(scope[n])
                         for n in program.param_vars if n in scope}
    return doc


def program_from_doc(doc, device=None) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """JSON document -> (Program, params scope). Inverse of
    program_to_doc. Placeholders and params are made on `device` (the
    default place when None)."""
    from ..framework.place import resolve_device
    from .program import Block, Program, _new_var, _Op, _slot_counter

    if doc.get("version") != _VERSION:
        raise ValueError(f"unsupported program doc version: "
                         f"{doc.get('version')!r}")
    device = resolve_device(device)
    program = Program()
    slot_to_var = {}
    if doc["vars"]:
        # keep future slot allocations clear of the preserved ids
        _slot_counter.advance_past(max(int(s) for s in doc["vars"]))
    with static_hook.suppressed():
        for s_str, vd in doc["vars"].items():
            slot = int(s_str)
            v = _new_var(torch.zeros(tuple(vd["shape"]),
                                     dtype=to_torch_dtype(vd["dtype"]),
                                     device=device),
                         name=vd.get("name"), is_param=vd["is_param"],
                         is_feed=vd["is_feed"])
            v.slot = slot   # preserve the saved SSA wiring
            slot_to_var[slot] = v
            program.vars[slot] = v
        for n, slot in doc["feed_vars"].items():
            program.feed_vars[n] = slot_to_var[slot]
        for n, slot in doc["param_vars"].items():
            program.param_vars[n] = slot_to_var[slot]
        if "loss_slot" in doc:
            program._loss_slot = doc["loss_slot"]

        for od in doc["ops"]:
            in_refs = [("s", int(r)) if t == "s" else
                       ("c", _tensor_unb64(r, device))
                       for t, r in od["inputs"]]
            op = _Op(od["type"],
                     _LoadedOp(base64.b64decode(od["export_b64"])),
                     in_refs, list(od["outputs"]), od.get("attrs") or {})
            program.ops.append(op)

        for bd in doc.get("blocks") or []:
            blk = Block(program, bd["idx"], bd["parent_idx"])
            for od in bd["ops"]:
                in_refs = [("s", int(r)) if t == "s" else
                           ("c", _tensor_unb64(r, device))
                           for t, r in od["inputs"]]
                blk.ops.append(_Op(od["type"], None, in_refs,
                                   list(od["outputs"]),
                                   od.get("attrs") or {}))
            program.blocks.append(blk)

        params = {n: _tensor_unb64(d, device)
                  for n, d in (doc.get("params") or {}).items()}
    program._doc_extra = doc.get("extra") or {}
    return program, params


def save_program(program, path: str, scope=None,
                 include_params: bool = True, extra=None) -> None:
    """Serialize a Program (and optionally its parameter values) to `path`
    (reference ProgramDesc.SerializeToString + save_persistables)."""
    from .program import global_scope
    scope = scope if scope is not None else global_scope()
    doc = program_to_doc(program, scope, include_params)
    if extra:
        doc["extra"] = extra
    with open(path, "w") as f:
        json.dump(doc, f)


def load_program(path: str, device=None):
    """Load a Program saved by save_program -> (Program, params dict) on
    `device` (the default place when None). Feed the params into a scope
    (or global_scope()) before Executor.run."""
    with open(path) as f:
        doc = json.load(f)
    return program_from_doc(doc, device)
