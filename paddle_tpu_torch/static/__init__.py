"""paddle.static namespace (port of `paddle_tpu.static`; reference
`python/paddle/static/`): Program / Executor / program_guard and the
recorder (`program`), the static layers and control flow (`nn`), mixed
precision (`amp`), the op-level document (`serde`), the pass manager
(`passes`), and save / load of inference models."""
import contextlib as _contextlib
import os as _os

import torch as _torch

from .input_spec import InputSpec  # noqa: F401
from .program import (Executor, Program, Variable, append_backward,  # noqa
                      data, default_main_program, default_startup_program,
                      disable_static, enable_static, global_scope,
                      in_static_mode, program_guard, scope_guard)
from .passes import PassManager, get_pass, register_pass  # noqa: F401
from .serde import load_program, save_program  # noqa: F401
from . import nn  # noqa: F401
from .nn import cond, while_loop  # noqa: F401
from . import amp  # noqa: F401


@_contextlib.contextmanager
def device_guard(device=None):
    """reference `fluid/framework.py device_guard`: pins ops to a device
    in the reference's per-op executor. Here the Executor runs a whole
    Program on its one place, so the hint is recorded as each op's
    `op_device` attr for inspection."""
    from .program import _state
    prev = _state.device_hint
    _state.device_hint = device
    try:
        yield
    finally:
        _state.device_hint = prev


class _ProgramModule(_torch.nn.Module):
    """A pruned Program's feed -> fetch replay as a module, its
    parameters held as buffers, for `torch.export`."""

    def __init__(self, lowered, params):
        super().__init__()
        self._lowered = lowered
        for i, p in enumerate(params):
            self.register_buffer(f"p{i}", p)
        self._n = len(params)

    def forward(self, *feeds):
        params = [getattr(self, f"p{i}") for i in range(self._n)]
        outs = self._lowered(list(feeds), params)
        return tuple(outs) if len(outs) > 1 else outs[0]


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None, **kwargs):
    """reference `fluid/io.py:1199` save_inference_model: prune the
    Program to the feed -> fetch computation, write it as a
    `torch.export` program (`.pdmodel`, through `jit.save`, loadable by
    `inference.Predictor`), its parameters by name (`.pdiparams`), and the
    op-level document (`.ptprog`)."""
    import torch

    from .. import jit
    from .program import _Lowered, recorder_paused
    program = program or default_main_program()
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) else \
        [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) else \
        [fetch_vars]
    # backward-slice to the serving subgraph (reference framework/prune.cc)
    program = program.prune(fetch_vars)
    device = executor.device if executor is not None else None
    lowered = _Lowered(program, [v.slot for v in fetch_vars], device)
    scope = global_scope()
    params = [scope[n].detach() for n in lowered.param_names]
    module = _ProgramModule(lowered, params)
    examples = [program.feed_vars[n].detach().as_subclass(torch.Tensor)
                for n in lowered.feed_names]
    with recorder_paused():
        jit.save(module, path_prefix, input_spec=examples)
    torch.save({n: p.cpu() for n, p in zip(lowered.param_names, params)},
               path_prefix + ".pdiparams")
    save_program(program, path_prefix + ".ptprog", scope=scope,
                 include_params=True,
                 extra={"fetch_slots": [v.slot for v in fetch_vars],
                        "fetch_names": [getattr(v, "name", None)
                                        for v in fetch_vars]})
    return [v.name for v in fetch_vars]


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Returns (program, feed_names, fetch_names).

    With the op-level `.ptprog` present (written by save_inference_model)
    a real Program is rebuilt on the executor's place (the default place
    without one: the card unless the thread asked for the CPU) —
    inspectable, re-executable through Executor, and differentiable; its
    parameters go into the global scope. Otherwise the fused `.pdmodel`
    loads as an `inference.Predictor` on that place."""
    from ..framework.place import resolve_device
    device = executor.device if executor is not None else \
        resolve_device(None)
    if _os.path.exists(path_prefix + ".ptprog"):
        program, params = load_program(path_prefix + ".ptprog", device)
        global_scope().update(params)
        feed_names = sorted(program.feed_vars.keys())
        extra = getattr(program, "_doc_extra", {})
        program._fetch_slots = extra.get("fetch_slots", [])
        fetch_names = extra.get("fetch_names", [])
        return program, feed_names, fetch_names
    from ..inference import Config, create_predictor
    pred = create_predictor(Config(path_prefix), device=device)
    return pred, pred.get_input_names(), ["output_0"]


def save(program, model_path, **kwargs):
    """The global scope's parameters as a pickled dict of numpy arrays
    (`{model_path}.pdparams`), as the JAX package writes it."""
    import pickle

    import torch
    state = {k: (v.float() if v.dtype == torch.bfloat16 else v)
             .detach().cpu().numpy() for k, v in global_scope().items()}
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(state, f, protocol=4)


def load(program, model_path, executor=None, var_list=None):
    """Read `{model_path}.pdparams` into the global scope, on the
    executor's place (the default place without one)."""
    import pickle

    import torch

    from ..framework.place import resolve_device
    device = executor.device if executor is not None else \
        resolve_device(None)
    with open(model_path + ".pdparams", "rb") as f:
        state = pickle.load(f)
    global_scope().update({k: torch.as_tensor(v).to(device)
                           for k, v in state.items()})
