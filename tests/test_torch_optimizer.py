"""paddle_tpu_torch optimizers, clip and LR schedules held to paddle_tpu's.

The same float32 parameters and the same numpy gradients go through the
JAX package's `apply_gradients_pytree` (its learning rate and step count
passed as it passes them from `Model.fit`) and through the port's
`Optimizer.step()` on `.grad`, for one and five steps of SGD, Momentum,
Adam and AdamW, with and without `ClipGradByGlobalNorm(1.0)` (the
gradients' global norm is ~5, so the clip is active), under
`LinearWarmup` and `CosineAnnealingDecay`. Parameters and moments agree
to rtol 1e-5, atol 1e-7: the update expressions are the same; the
scalars (lr, bias corrections) are host doubles in the port and float32
arrays in JAX, which moves the last bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm as TClip

SHAPES = [(4, 3), (5,), (2, 2, 3)]
RTOL, ATOL = 1e-5, 1e-7


def _scheds(kind):
    if kind == "warmup":
        return (jopt.lr.LinearWarmup(0.05, 3, 0.01, 0.05),
                topt.lr.LinearWarmup(0.05, 3, 0.01, 0.05))
    return (jopt.lr.CosineAnnealingDecay(0.05, T_max=4),
            topt.lr.CosineAnnealingDecay(0.05, T_max=4))


def _make(name, jsched, tsched, clip, params):
    jc = JClip(1.0) if clip else None
    tc = TClip(1.0) if clip else None
    if name == "SGD":
        return (jopt.SGD(jsched, weight_decay=0.01, grad_clip=jc),
                topt.SGD(tsched, params, weight_decay=0.01, grad_clip=tc))
    if name == "Momentum":
        return (jopt.Momentum(jsched, 0.9, weight_decay=0.01, grad_clip=jc),
                topt.Momentum(tsched, 0.9, params, weight_decay=0.01,
                              grad_clip=tc))
    if name == "Adam":
        return (jopt.Adam(jsched, weight_decay=0.01, grad_clip=jc),
                topt.Adam(tsched, parameters=params, weight_decay=0.01,
                          grad_clip=tc))
    return (jopt.AdamW(jsched, weight_decay=0.01, grad_clip=jc),
            topt.AdamW(tsched, parameters=params, weight_decay=0.01,
                       grad_clip=tc))


def _grads(rng):
    return [(rng.standard_normal(s) * 1.5).astype(np.float32)
            for s in SHAPES]


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("sched", ["warmup", "cosine"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_update_matches_apply_gradients_pytree(name, clip, sched, steps):
    rng = np.random.RandomState(hash((name, clip, sched)) % 1000)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jsched, tsched = _scheds(sched)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    jo, to = _make(name, jsched, tsched, clip, tparams)
    jparams = [jnp.asarray(a) for a in p0]
    jstate = jo.init_state_pytree(jparams)
    for step in range(1, steps + 1):
        g = _grads(rng)
        jparams, jstate = jo.apply_gradients_pytree(
            [jnp.asarray(a) for a in g], jparams, jstate,
            jnp.asarray(jo.get_lr(), "float32"), jnp.asarray(step, "int32"))
        for p, a in zip(tparams, g):
            p.grad = torch.from_numpy(a)
        to.step()
        to.clear_grad()
        assert all(p.grad is None for p in tparams)
        jsched.step()
        tsched.step()
    for i, (tp, jp) in enumerate(zip(tparams, jparams)):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=RTOL, atol=ATOL, err_msg=f"p{i}")
    sd = to.state_dict()
    assert sd["global_step"] == steps and "LR_Scheduler" in sd
    for i, st in enumerate(jstate):
        for k, v in st.items():
            np.testing.assert_allclose(sd[f"param_{i}_{k}"].numpy(),
                                       np.asarray(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"param_{i}_{k}")


def test_clip_scale_is_the_jax_scale():
    rng = np.random.RandomState(3)
    g = _grads(rng)
    want = JClip(1.0)._tree_clip([jnp.asarray(a) for a in g])
    got = TClip(1.0)._clip_grads([torch.from_numpy(a) for a in g])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    # below the norm: untouched; None grads pass through the pair API
    small = [torch.from_numpy(a * 1e-3) for a in g]
    for a, b in zip(TClip(1.0)._clip_grads(small), small):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pairs = TClip(1.0)([("a", torch.from_numpy(g[0])), ("b", None)])
    assert pairs[1] == ("b", None)


def test_state_dict_round_trip():
    rng = np.random.RandomState(4)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    named = [(f"w{i}", torch.nn.Parameter(torch.from_numpy(a.copy())))
             for i, a in enumerate(p0)]
    sched = topt.lr.LinearWarmup(0.05, 3, 0.01, 0.05)
    a = topt.AdamW(sched, parameters=named, grad_clip=TClip(1.0))
    for _ in range(3):
        for (_, p), g in zip(named, _grads(rng)):
            p.grad = torch.from_numpy(g)
        a.step()
        a.clear_grad()
        sched.step()
    sd = a.state_dict()
    assert {"global_step", "LR_Scheduler", "w0_moment1", "w2_moment2"} \
        <= set(sd)
    twin = [(n, torch.nn.Parameter(p.detach().clone())) for n, p in named]
    sched2 = topt.lr.LinearWarmup(0.05, 3, 0.01, 0.05)
    b = topt.AdamW(sched2, parameters=twin, grad_clip=TClip(1.0))
    b.set_state_dict(sd)
    assert b._global_step == 3 and b.get_lr() == a.get_lr()
    g = _grads(rng)
    for params, opt in ((named, a), (twin, b)):
        for (_, p), x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for (_, p), (_, q) in zip(named, twin):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
