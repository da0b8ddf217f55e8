"""Inference analysis pipeline (port of `paddle_tpu.inference.analysis`;
reference `inference/analysis/`: `Analyzer` running ordered
`AnalysisPass`es over an `Argument`, and the TensorRT/Lite subgraph
engines of `analysis/ir_passes/`).

The Analyzer does the structural part of the reference pipeline: load a
serialized Program, fold and prune it, and cluster op ranges into ENGINE
ops. An engine op is the Lite/TensorRT analogue: a contiguous sub-DAG of
the Program replaced by ONE op whose body runs the fused slice
(reference `operators/lite/lite_engine_op.h`, `tensorrt_engine_op.h`).
The JAX package compiles that body with `jax.jit`; here the body
replays the slice's ops in order (`static.program.run_ops`), which keeps
it differentiable and runs on whatever device its inputs are on.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..framework.errors import NotFoundError

__all__ = ["Argument", "Analyzer", "AnalysisPass", "register_analysis_pass",
           "engine_subgraph_pass", "compile_subgraph_engine"]


class Argument:
    """Pass pipeline state (reference `analysis/argument.h` — a typed
    property bag handed from pass to pass)."""

    def __init__(self, program=None, scope=None, fetch_targets=None,
                 model_path=None, device=None):
        self.program = program
        self.scope = scope if scope is not None else {}
        self.fetch_targets = fetch_targets
        self.model_path = model_path
        self.device = device
        self.engine_ops: List[int] = []    # indices of fused engine ops


_ANALYSIS_PASSES: Dict[str, Callable[[Argument], None]] = {}


def register_analysis_pass(name: str):
    def deco(fn):
        _ANALYSIS_PASSES[name] = fn
        return fn
    return deco


class AnalysisPass:
    """Callable wrapper so passes can also be used OO-style (reference
    `analysis/analysis_pass.h`)."""

    def __init__(self, name: str):
        self.name = name

    def run(self, argument: Argument):
        _ANALYSIS_PASSES[self.name](argument)


@register_analysis_pass("ir_graph_build_pass")
def _ir_graph_build(arg: Argument):
    """Load the serialized Program (reference ir_graph_build_pass reads
    the ProgramDesc), on `arg.device` (the default place when None)."""
    if arg.program is None:
        from ..static.serde import load_program
        arg.program, params = load_program(arg.model_path, arg.device)
        arg.scope.update(params)


@register_analysis_pass("ir_analysis_pass")
def _ir_analysis(arg: Argument):
    """Constant folding (reference runs the selected ir fusion passes)."""
    from ..static.passes import get_pass
    get_pass("constant_folding_pass")(arg.program)


@register_analysis_pass("memory_optimize_pass")
def _memory_optimize(arg: Argument):
    """Dead-code elimination against the fetch targets (reference
    memory_optimize_pass reuses buffers; the lever at this level is
    dropping dead ops and vars)."""
    if arg.fetch_targets:
        from ..static.passes import get_pass
        get_pass("dead_code_elimination_pass")(arg.program,
                                               targets=arg.fetch_targets)


@register_analysis_pass("engine_subgraph_pass")
def engine_subgraph_pass(arg: Argument):
    """Cluster the largest fusable contiguous op range into one engine op
    (reference tensorrt_subgraph_pass / lite_subgraph_pass mark maximal
    subgraphs and replace them with engine ops)."""
    prog = arg.program
    if len(prog.ops) >= 2:
        fetch = [t.slot for t in (arg.fetch_targets or [])
                 if hasattr(t, "slot")]
        idx = compile_subgraph_engine(prog, 0, len(prog.ops),
                                      fetch_slots=fetch)
        arg.engine_ops.append(idx)


@register_analysis_pass("ir_graph_to_program_pass")
def _ir_graph_to_program(arg: Argument):
    """Terminal no-op: the Program IS the executable representation
    (reference converts the ir::Graph back to a ProgramDesc)."""


def compile_subgraph_engine(program, start: int, stop: int,
                            engine_type: str = "torch",
                            fetch_slots: Sequence[int] = ()) -> int:
    """Replace program.ops[start:stop] with ONE engine op
    `{engine_type}_engine`.

    The slice's external inputs/outputs are computed from slot liveness;
    the engine body replays the slice — the contract of the reference's
    engine ops (feed the subgraph's inputs, run the engine, fetch its
    outputs). Returns the index of the engine op in the rewritten op
    list."""
    from ..static.program import _Op, run_ops

    ops = program.ops
    slice_ops = ops[start:stop]
    produced = {s for op in slice_ops for s in op.out_slots}
    ext_in: List[int] = []
    for op in slice_ops:
        for tag, ref in op.in_refs:
            if tag == "s" and ref not in produced and ref not in ext_in:
                ext_in.append(ref)
    # outputs: slice-produced slots consumed by later ops or fetched;
    # with neither known, every produced slot stays fetchable
    used_later = {ref for op in ops[stop:] for tag, ref in op.in_refs
                  if tag == "s"}
    keep = used_later | set(fetch_slots)
    out_slots = sorted(produced & keep) if produced & keep \
        else sorted(produced)

    def engine_body(*ext_vals):
        dev = next((v.device for v in ext_vals), None)
        env = run_ops(program, slice_ops, dict(zip(ext_in, ext_vals)), dev)
        return tuple(env[s] for s in out_slots)

    engine = _Op(f"{engine_type}_engine", engine_body,
                 [("s", s) for s in ext_in], list(out_slots),
                 {"engine_type": engine_type,
                  "fused_op_types": [op.name for op in slice_ops],
                  "num_fused_ops": len(slice_ops)})
    program.ops = ops[:start] + [engine] + ops[stop:]
    program._version = getattr(program, "_version", 0) + 1
    return start


class Analyzer:
    """Ordered pass driver (reference `analysis/analyzer.cc:Analyzer::
    RunAnalysis`)."""

    DEFAULT_PASSES = ["ir_graph_build_pass", "ir_analysis_pass",
                      "memory_optimize_pass", "engine_subgraph_pass",
                      "ir_graph_to_program_pass"]

    def __init__(self, passes: Optional[Sequence[str]] = None):
        self.passes = list(passes if passes is not None
                           else self.DEFAULT_PASSES)

    def run(self, argument: Argument) -> Argument:
        for name in self.passes:
            if name not in _ANALYSIS_PASSES:
                raise NotFoundError(f"unknown analysis pass {name!r}; "
                                    f"have {sorted(_ANALYSIS_PASSES)}")
            _ANALYSIS_PASSES[name](argument)
        return argument
