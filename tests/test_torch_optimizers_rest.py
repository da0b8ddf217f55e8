"""The six optimizers this slice adds (Adamax, Adagrad, Adadelta, RMSProp,
Lamb, LarsMomentum) held to paddle_tpu's.

- The same float32 parameters and numpy gradients through the JAX
  package's `apply_gradients_pytree` under `jax.jit` (lr float32, step
  int32, as its `Model.fit` passes them) and the port's `step()` on `.grad`, for three
  steps, with weight decay where the optimizer takes it and with a
  global-norm clip: parameters and every state within
  1e-5 x max(1, max |ref|); the state names are the reference's.
- Lamb stores `exclude_from_weight_decay_fn` and never calls it (ROADMAP
  C22); LarsMomentum's local rate is 1 where a norm is 0.
- A `.pdopt` of each, written by one package, opens in the other
  (`paddle.save` / `paddle.load` of `state_dict()`, then
  `set_state_dict`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.framework.tensor import Parameter as JParameter

SHAPES = [(4, 3), (5,), (2, 2, 3)]
TOL = 1e-5

OPTS = {
    # name: (constructor kwargs, state names)
    "Adamax": ({"learning_rate": 0.02, "weight_decay": 0.01},
               ["inf_norm", "moment"]),
    "Adagrad": ({"learning_rate": 0.05, "initial_accumulator_value": 0.1,
                 "weight_decay": 0.01}, ["moment"]),
    "Adadelta": ({"learning_rate": 0.5, "rho": 0.9}, [
        "avg_squared_grad", "avg_squared_update"]),
    "RMSProp": ({"learning_rate": 0.01, "momentum": 0.9},
                ["mean_square", "momentum_acc"]),
    "RMSProp#centered": ({"learning_rate": 0.01, "centered": True,
                          "weight_decay": 0.02},
                         ["mean_grad", "mean_square", "momentum_acc"]),
    "Lamb": ({"learning_rate": 0.01, "lamb_weight_decay": 0.05},
             ["moment1", "moment2"]),
    "LarsMomentum": ({"learning_rate": 0.1, "lars_coeff": 0.01},
                     ["velocity"]),
}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _pair(name, clip, params):
    cls = name.split("#")[0]
    kw = dict(OPTS[name][0])
    jo = getattr(paddle.optimizer, cls)(
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None,
        **kw)
    to = getattr(ptt.optimizer, cls)(
        parameters=params,
        grad_clip=ptt.nn.ClipGradByGlobalNorm(1.0) if clip else None, **kw)
    return jo, to


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_three_steps_match_jax(name, clip):
    rng = np.random.RandomState(len(name) + clip)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if name == "LarsMomentum":
        p0[1][:] = 0.0      # a zero norm: the local rate falls back to 1
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    jo, to = _pair(name, clip, tparams)
    jparams = [jnp.asarray(a) for a in p0]
    jstate = jo.init_state_pytree(jparams)
    apply = jax.jit(jo.apply_gradients_pytree)     # as Model.fit runs it
    for step in range(1, 4):
        g = [(rng.standard_normal(s) * 1.5).astype(np.float32)
             for s in SHAPES]
        jparams, jstate = apply(
            [jnp.asarray(a) for a in g], jparams, jstate,
            jnp.asarray(jo.get_lr(), "float32"), jnp.asarray(step, "int32"))
        for p, a in zip(tparams, g):
            p.grad = torch.from_numpy(a)
        to.step()
        to.clear_grad()
    for i, (tp, jp) in enumerate(zip(tparams, jparams)):
        _close(tp.detach().numpy(), jp, f"{name} param {i}")
        st = to._accumulators[id(tp)]
        assert sorted(st) == OPTS[name][1] == sorted(jstate[i])
        for k in st:
            _close(st[k].numpy(), jstate[i][k], f"{name} {k} {i}")


def test_lamb_ignores_exclude_from_weight_decay_fn():
    """A step with an exclusion function that excludes every parameter
    is the step without one, in both packages, and the function is
    never called."""
    def port(fn):
        p = torch.nn.Parameter(torch.ones(3, 2))
        opt = ptt.optimizer.Lamb(0.1, lamb_weight_decay=0.5, parameters=[p],
                                 exclude_from_weight_decay_fn=fn)
        p.grad = torch.full((3, 2), 0.3)
        opt.step()
        return p.detach().numpy()

    def ref(fn):
        p = JParameter(jnp.ones((3, 2), "float32"), name="w")
        opt = paddle.optimizer.Lamb(0.1, lamb_weight_decay=0.5,
                                    parameters=[p],
                                    exclude_from_weight_decay_fn=fn)
        p._grad = jnp.full((3, 2), 0.3, "float32")
        opt.step()
        return np.asarray(p.numpy())
    calls = []
    for run in (port, ref):
        np.testing.assert_array_equal(
            run(lambda n: calls.append(n) or True), run(None))
    assert calls == []
    _close(port(None), ref(None), "Lamb step")


def _jparams(p0):
    return [JParameter(jnp.asarray(a), name=f"w{i}") for i, a in
            enumerate(p0)]


@pytest.mark.parametrize("name", ["Adamax", "Adagrad", "Adadelta",
                                  "RMSProp#centered", "Lamb",
                                  "LarsMomentum"])
def test_pdopt_opens_in_either_package(name, tmp_path):
    """Two steps in one package, its state_dict through its save, the
    other package's load and set_state_dict: the same accumulators."""
    rng = np.random.RandomState(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    cls = name.split("#")[0]
    kw = dict(OPTS[name][0])
    # port -> JAX
    tparams = [(f"w{i}", torch.nn.Parameter(torch.from_numpy(a.copy())))
               for i, a in enumerate(p0)]
    to = getattr(ptt.optimizer, cls)(parameters=tparams, **kw)
    for _ in range(2):
        for _, p in tparams:
            p.grad = torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32))
        to.step()
    ptt.save(to.state_dict(), str(tmp_path / "port.pdopt"))
    jps = _jparams(p0)
    jo = getattr(paddle.optimizer, cls)(parameters=jps, **kw)
    jo.set_state_dict(paddle.load(str(tmp_path / "port.pdopt")))
    assert jo._global_step == 2
    for (_, tp), jp in zip(tparams, jps):
        for k, v in to._accumulators[id(tp)].items():
            _close(np.asarray(jo._accumulators[id(jp)][k]), v.numpy(), k)
    # JAX -> port
    for jp in jps:
        jp._grad = jnp.asarray(rng.standard_normal(jp.shape), "float32")
    jo.step()
    paddle.save(jo.state_dict(), str(tmp_path / "jax.pdopt"))
    fresh = [(n, torch.nn.Parameter(p.detach().clone())) for n, p in tparams]
    to2 = getattr(ptt.optimizer, cls)(parameters=fresh, **kw)
    to2.set_state_dict(ptt.load(str(tmp_path / "jax.pdopt")))
    assert to2._global_step == 3
    for (_, tp), jp in zip(fresh, jps):
        for k, v in jo._accumulators[id(jp)].items():
            _close(to2._accumulators[id(tp)][k].numpy(), np.asarray(v), k)
