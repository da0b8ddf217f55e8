"""Program-level IR passes (port of `paddle_tpu.static.passes`;
reference `paddle/fluid/framework/ir/` pass registry +
`inference/analysis/` pass pipeline).

What is meaningful at this level is graph hygiene on the op list:
constant folding (fewer ops to export in `.ptprog`) and dead-code
elimination (Program.prune). The PassManager mirrors the reference's
apply-in-sequence contract so tooling can be ported."""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..framework import static_hook
from ..framework.errors import NotFoundError

__all__ = ["PassManager", "constant_folding_pass",
           "dead_code_elimination_pass", "register_pass", "get_pass"]

_PASSES: Dict[str, Callable] = {}


def register_pass(name: str):
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def get_pass(name: str) -> Callable:
    if name not in _PASSES:
        raise NotFoundError(f"unknown pass {name!r}; have "
                            f"{sorted(_PASSES)}")
    return _PASSES[name]


@register_pass("constant_folding_pass")
def constant_folding_pass(program, targets=None):
    """Evaluate ops whose inputs are all constants and splice the results
    in as constants (reference `framework/ir/constant_folding_pass.cc`).
    Only touches ops that depend on no feed or parameter."""
    folded_vals = {}
    new_ops = []
    for op in program.ops:
        ins = []
        all_const = True
        for tag, ref in op.in_refs:
            if tag == "c":
                ins.append(ref)
            elif ref in folded_vals:
                ins.append(folded_vals[ref])
            else:
                all_const = False
                break
        if not all_const:
            # rewrite any input slots that earlier folding produced
            op.in_refs = [("c", folded_vals[r]) if t == "s"
                          and r in folded_vals else (t, r)
                          for t, r in op.in_refs]
            new_ops.append(op)
            continue
        with static_hook.suppressed(), torch.no_grad():
            outs = op.fn(*ins)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        for s, v in zip(op.out_slots, outs):
            folded_vals[s] = v
    program.ops = new_ops
    program._version = getattr(program, "_version", 0) + 1
    return program


@register_pass("dead_code_elimination_pass")
def dead_code_elimination_pass(program, targets=None):
    """Backward-slice to the target vars (Program.prune; reference
    `framework/prune.cc`). Without targets this is the identity. Mutates
    `program` IN PLACE like every pass."""
    if not targets:
        return program
    pruned = program.prune(targets)
    program.ops = pruned.ops
    program.feed_vars = pruned.feed_vars
    program.param_vars = pruned.param_vars
    program._version = getattr(program, "_version", 0) + 1
    return program


class PassManager:
    """Apply named passes in sequence (reference ir::PassRegistry +
    analysis Argument pipeline)."""

    def __init__(self, passes: List[str] = None):
        self.passes = list(passes or [])

    def apply(self, program, targets=None):
        for name in self.passes:
            program = get_pass(name)(program, targets=targets) or program
        return program
