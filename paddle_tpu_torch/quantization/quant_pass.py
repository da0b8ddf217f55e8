"""Static-Program quantization passes (port of
`paddle_tpu.quantization.quant_pass`; reference `fluid/contrib/slim/
quantization/quantization_pass.py`: QuantizationTransformPass inserts
fake_quant/dequant ops for QAT; QuantizationFreezePass rewrites the
trained program to int8 weights).

Over the op-level Program: the transform pass WRAPS each quantizable op
(selected by name: `matmul`, `mul`, `linear`, `conv2d`) with fake-quant
on its floating inputs (straight-through estimator: autograd
differentiates the wrapped callable, no separate grad ops); the freeze
pass bakes the WEIGHT (the >=2-D parameter input) in as an int8 constant
with per-output-channel scales, drops it from the program's parameter
table, and dequantizes inside the op body. The codes and scales are
computed in numpy as the JAX package's are, so they come out bit-equal
to its (transposed for the `nn.Linear` layer's [out, in] weight, whose
recorded op says so in its `weight_layout` attr).

Only block-0 ops are rewritten: ops recorded inside cond/while
sub-blocks run through their parent op, which a Program-level pass does
not reach (a warning says so).
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import fake_quant_array

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "fake_quant_array"]

_DEFAULT_TYPES = ("matmul", "mul", "linear", "conv2d")


def _pre_quant_store(program) -> Dict[int, object]:
    """Per-program stash of pre-QAT callables keyed by id(op)."""
    store = getattr(program, "_pre_quant_fns", None)
    if store is None:
        store = program._pre_quant_fns = {}
    return store


def _is_float(a):
    return torch.is_tensor(a) and a.is_floating_point()


def _bump(program):
    """Invalidate Executor caches: their key includes the program
    version, which every rewriting pass bumps."""
    program._version = getattr(program, "_version", 0) + 1


def _warn_sub_blocks(program, pass_name):
    if getattr(program, "num_blocks", 1) > 1:
        warnings.warn(
            f"{pass_name}: ops inside cond/while sub-blocks run through "
            "their parent op and are NOT quantized")


class QuantizationTransformPass:
    """Wrap quantizable ops with fake-quant on every floating input
    (QAT; reference QuantizationTransformPass inserts
    fake_quantize_abs_max + fake_dequantize ops around each). Parameter
    inputs quantize at weight_bits, everything else at activation_bits.
    """

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_types: Sequence[str] = _DEFAULT_TYPES):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.types = tuple(quantizable_op_types)

    def apply(self, program):
        _warn_sub_blocks(program, "QuantizationTransformPass")
        param_slots = {v.slot for v in program.param_vars.values()}
        store = _pre_quant_store(program)
        for op in program.ops:
            if op.name not in self.types or op.attrs.get("quant"):
                continue
            arg_bits = [self.weight_bits if tag == "s" and ref in
                        param_slots else self.activation_bits
                        for tag, ref in op.in_refs]
            inner = op.fn
            # the freeze pass replaces (not stacks on) this wrapper
            store[id(op)] = inner

            def wrapped(*args, _inner=inner, _bits=tuple(arg_bits)):
                return _inner(*[fake_quant_array(a, b) if _is_float(a)
                                else a for a, b in zip(args, _bits)])
            op.fn = wrapped
            op.attrs["quant"] = "fake_abs_max"
            op.attrs["weight_bits"] = self.weight_bits
            op.attrs["activation_bits"] = self.activation_bits
        _bump(program)
        return program


def _channel_axes(op, w):
    """The axes a per-output-channel scale reduces over: conv weights
    are OIHW; the `nn.Linear` layer's weight is [out, in]; every other
    matmul/linear weight puts the output features last."""
    if op.name == "conv2d" and w.ndim == 4:
        return (1, 2, 3)
    if op.attrs.get("weight_layout") == "out_in":
        return tuple(range(1, w.ndim))
    return tuple(range(w.ndim - 1))


class QuantizationFreezePass:
    """Bake the weight input of quantizable ops in as an int8 constant
    (reference QuantizationFreezePass converts weights and rewires
    dequantize after the op). The weight is the >=2-D parameter input
    (biases stay float32); per-output-channel symmetric scales ride as
    one more constant input of the op; the frozen parameter leaves
    program.param_vars so serialized artifacts carry the int8 bytes."""

    def __init__(self, weight_bits: int = 8,
                 quantizable_op_types: Sequence[str] = _DEFAULT_TYPES):
        self.weight_bits = weight_bits
        self.types = tuple(quantizable_op_types)

    def apply(self, program, scope: Optional[Dict[str, torch.Tensor]] = None):
        from ..static.program import global_scope
        scope = scope if scope is not None else global_scope()
        _warn_sub_blocks(program, "QuantizationFreezePass")
        qmax = 2.0 ** (self.weight_bits - 1) - 1
        param_slots = {v.slot: n for n, v in program.param_vars.items()}

        frozen_slots = []
        for op in program.ops:
            if op.name not in self.types or op.attrs.get("frozen"):
                continue
            w_positions = [
                i for i, (tag, ref) in enumerate(op.in_refs)
                if tag == "s" and ref in param_slots
                and scope[param_slots[ref]].dim() >= 2]
            if not w_positions:
                continue
            pos = w_positions[0]
            slot = op.in_refs[pos][1]
            name = param_slots[slot]
            wt = scope[name]
            w = wt.detach().float().cpu().numpy()
            scale = np.maximum(np.abs(w).max(axis=_channel_axes(op, w),
                                              keepdims=True),
                               1e-8) / qmax
            wq = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)

            # replace (don't stack on) the QAT wrapper for the WEIGHT
            # only; activation fake-quant survives the freeze, as the
            # reference removes only the weight fake_quant ops
            pre_qat = _pre_quant_store(program).pop(id(op), None)
            if pre_qat is not None:
                act_bits = int(op.attrs.get("activation_bits", 8))

                def inner(*args, _raw=pre_qat, _wpos=pos,
                          _abits=act_bits):
                    return _raw(*[
                        a if i == _wpos or not _is_float(a)
                        else fake_quant_array(a, _abits)
                        for i, a in enumerate(args)])
            else:
                inner = op.fn
            if op.attrs.pop("quant", None):
                op.attrs["qat_trained"] = True

            def frozen(*args, _inner=inner, _pos=pos):
                *args, scale_t = args
                args[_pos] = args[_pos].to(torch.float32) * scale_t
                return _inner(*args)
            op.fn = frozen
            op.in_refs[pos] = ("c", torch.from_numpy(wq).to(wt.device))
            op.in_refs.append(("c", torch.from_numpy(
                scale.astype(np.float32)).to(wt.device)))
            op.attrs["frozen"] = "int8"
            op.attrs["weight_bits"] = self.weight_bits
            op.attrs["weight_scale_max"] = float(scale.max())
            frozen_slots.append(slot)

        # drop frozen weights from the parameter table unless another op
        # still reads them
        still_used = {ref for b in program.blocks for o in b.ops
                      for tag, ref in o.in_refs if tag == "s"}
        for slot in frozen_slots:
            if slot not in still_used and slot in param_slots:
                program.param_vars.pop(param_slots[slot], None)
        _bump(program)
        return program
