"""Every public name of paddle_tpu has its counterpart in
paddle_tpu_torch, module for module.

For each module of the JAX package with a port module at the same path
(`paddle_tpu/x/y.py` and `paddle_tpu_torch/x/y.py`, a package's
`__init__.py` included), the reference's public names are its `__all__`
or, without one, the names it defines or re-exports from the package
(modules and objects of other libraries aside); the port module must
have each of them, but those in `ALLOWED`, each with its reason. The
reference modules with no port module at their path are `NO_PORT_FILE`,
each with its reason. Both lists are exact: an entry the port no longer
needs fails the test, so they only shrink.
"""
import importlib
import os
import types

import pytest

import paddle_tpu
import paddle_tpu_torch

REF = os.path.dirname(paddle_tpu.__file__)
PORT = os.path.dirname(paddle_tpu_torch.__file__)

_JAX_ONLY = ("the JAX package's own machinery, which the port does not "
             "have by design (ROADMAP C44): torch tensors, autograd and "
             "generators stand in its place")

# {module: {name: reason}}: public names of the reference the port lacks
ALLOWED = {
    "": {
        "Tensor": "the port's tensors are torch.Tensor (ROADMAP A)",
        "Parameter": "a parameter is a torch.nn.Parameter (ROADMAP A)",
        "VarBase": "the reference's alias of its Tensor class (ROADMAP A)",
        "annotations": "the reference's `from __future__ import "
                       "annotations`, not an API name",
    },
    "nn": {"Parameter": "a parameter is a torch.nn.Parameter, made by "
                        "nn.Layer.create_parameter (ROADMAP A)"},
    "framework": {n: _JAX_ONLY for n in (
        "Tensor", "Parameter", "apply_op", "defop", "trace_mode",
        "in_trace_mode", "to_jax_dtype", "device_for", "get_rng_key")},
    "framework.dtype": {"to_jax_dtype": _JAX_ONLY},
    "framework.place": {"device_for": _JAX_ONLY},
    "framework.random": {"get_rng_key": _JAX_ONLY},
    "parallel": {"compat_shard_map": _JAX_ONLY,
                 "mapped_axis_size": _JAX_ONLY},
    "parallel.spmd": {"compat_shard_map": _JAX_ONLY},
    "profiler.device_telemetry": {"note_train_step_lowering": _JAX_ONLY},
    "onnx": {"JaxprToOnnx": "the JAX exporter's jaxpr walker; the port "
                            "exports its own torch.export trace "
                            "(onnx.export)"},
    "onnx.export": {"JaxprToOnnx": "the JAX exporter's jaxpr walker; the "
                                   "port exports its own torch.export "
                                   "trace (onnx.export)"},
    "ops.splash_ops": {
        "splash_attention_raw": "the JAX package's custom_vjp entry over "
                                "its Pallas kernels; the port's is "
                                "`splash_attention` over K5-K7",
        "STATS": "the JAX package's trace counters; the port counts "
                 "launches in STAT_splash_attention_* and each wrapper's "
                 "`.launches`"},
    "ops.tensor_methods": {
        "Tensor": _JAX_ONLY, "apply_op": _JAX_ONLY,
        "fn": "a loop variable of the reference module, not an API name",
        "n": "a loop variable of the reference module, not an API name",
        "names": "a loop variable of the reference module, not an API "
                 "name"},
}

# reference modules with no port module at the same path
NO_PORT_FILE = {
    "framework/tensor.py": "the port does not wrap torch.Tensor "
                           "(ROADMAP A, by design)",
    "framework/autograd.py": "torch autograd replaces the apply_op tape "
                             "(ROADMAP A, by design)",
    "framework/functional.py": "the JAX package's functional capture of a "
                               "layer; torch modules hold their state "
                               "(ROADMAP A, by design)",
    "framework/deferred.py": "the JAX package's deferred dispatch "
                             "(ROADMAP A, by design)",
    "ops/pallas_ops.py": "ported as ops/flash_ops.py (K2-K4)",
}


def _modules():
    out = []
    for d, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), REF))
    return sorted(out)


def _dotted(rel):
    m = rel[:-3].replace(os.sep, ".")
    return "" if m == "__init__" else m.removesuffix(".__init__")


def _public(mod, pkg):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        o = getattr(mod, n)
        if isinstance(o, types.ModuleType):
            continue
        if callable(o) or isinstance(o, type):
            if not str(getattr(o, "__module__", "")).startswith(pkg):
                continue
        out.add(n)
    return out


PAIRED = [rel for rel in _modules()
          if os.path.exists(os.path.join(PORT, rel))]


def test_unported_modules_are_the_listed_ones():
    missing = {rel for rel in _modules()
               if not os.path.exists(os.path.join(PORT, rel))}
    assert missing == set(NO_PORT_FILE)


def test_allowlist_entries_name_paired_modules_and_give_reasons():
    paired = {_dotted(rel) for rel in PAIRED}
    assert set(ALLOWED) <= paired
    for mod, names in ALLOWED.items():
        for n, why in names.items():
            assert isinstance(why, str) and len(why) > 20, (mod, n)


@pytest.mark.parametrize("rel", PAIRED)
def test_module_has_the_reference_public_names(rel):
    name = _dotted(rel)
    ref = importlib.import_module("paddle_tpu" + (f".{name}" if name
                                                  else ""))
    port = importlib.import_module("paddle_tpu_torch" + (f".{name}" if name
                                                         else ""))
    lacking = {n for n in _public(ref, "paddle_tpu")
               if not hasattr(port, n)}
    assert sorted(lacking) == sorted(ALLOWED.get(name, {}))
