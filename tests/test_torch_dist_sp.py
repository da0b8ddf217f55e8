"""paddle_tpu_torch's sequence-parallel attention and sp train step held to
paddle_tpu's on the 8-virtual-device CPU mesh.

The port runs two gloo ranks (`torch_dist_ranks.py` job "sp", one spawn);
the JAX side runs `shard_map_ring_attention` and `make_sharded_train_step(
sp_axis="sp")` on a mesh of two virtual devices, from the same inputs and
weights (`load_reference_state`). Ring and Ulysses attention at sp 2,
causal and not, fp32 and bf16: outputs and q/k/v gradients within 1e-5
(fp32) and 2e-2 (bf16) of the JAX package's (`tests/test_distributed.py:
155-200`'s calls). The GPT with `use_ring=True` through the sp step: losses
and parameters after 2 SGD steps within rtol 1e-5. A GPT whose attention
is not sequence-parallel is refused with a typed error naming the layer.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.ops.manipulation import reshape
from paddle_tpu.parallel import (create_mesh, make_sharded_train_step,
                                 mesh_scope, set_mesh)
from paddle_tpu.parallel.ring_attention import shard_map_ring_attention

from torch_dist_ranks import _params, start_ranks, tiny_lm

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STEP = dict(rtol=1e-5, atol=1e-6)


def _cfg():
    return GPTConfig.tiny(vocab_size=128, num_layers=4, hidden_size=32,
                          num_heads=2, intermediate_size=64,
                          max_position_embeddings=32, dropout=0.0)


def _inputs():
    rng = np.random.RandomState(2)
    a = {x: rng.randn(2, 4, 32, 8).astype("float32")
         for x in ("q", "k", "v", "dout")}
    a["ids"] = rng.randint(0, 128, size=(4, 16)).astype("int64")
    a["tgt"] = rng.randint(0, 128, size=(4, 16)).astype("int64")
    paddle.seed(0)
    net = GPTForCausalLM(_cfg())
    for k, v in net.state_dict().items():
        a[f"gpt.{k}"] = v.numpy()
    return a


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("sp")
    inp = _inputs()
    np.savez(wd / "in.npz", **inp)
    job = start_ranks("sp", 2, str(wd))
    yield inp, job
    job.close()


def _mesh2():
    return create_mesh({"sp": 2}, devices=jax.devices()[:2])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_attention_matches_jax(ranks, impl, causal, dt):
    inp, job = ranks
    mesh = _mesh2()
    q, k, v = (jnp.asarray(inp[x], getattr(jnp, dt)) for x in "qkv")
    dout = jnp.asarray(inp["dout"])

    def f(q, k, v):
        o = shard_map_ring_attention(q, k, v, mesh, causal=causal,
                                     impl=impl)
        return jnp.sum(o.astype(jnp.float32) * dout), o
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    set_mesh(None)
    tag = f"{impl}.{causal}.{dt}"
    for got in job.wait():
        assert str(got[f"{tag}.dtype"]) == f"torch.{dt}"
        np.testing.assert_allclose(got[f"{tag}.out"],
                                   np.asarray(out, np.float32), **TOL[dt])
        for x, g in zip("qkv", grads):
            np.testing.assert_allclose(got[f"{tag}.d{x}"],
                                       np.asarray(g, np.float32), **TOL[dt])


def _jax_sp_step(inp):
    paddle.seed(0)
    net = GPTForCausalLM(_cfg())

    class Ring(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.m = net

        def forward(self, x):
            return self.m(x, use_ring=True)
    ce = jnn.CrossEntropyLoss()

    def lm_loss(outs, labels):
        out = outs[0] if isinstance(outs, (list, tuple)) else outs
        b, s, vv = out.shape
        return ce(reshape(out, [b * s, vv]), reshape(labels[0], [b * s]))
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    ids, tgt = inp["ids"].astype("int32"), inp["tgt"].astype("int32")
    with mesh_scope(_mesh2()):
        step, st = make_sharded_train_step(Ring(), opt, lm_loss,
                                           sp_axis="sp", zero_stage=0)
        losses = []
        for _ in range(2):
            st, lv = step(st, (ids,), (tgt,), rng=jax.random.PRNGKey(0))
            losses.append(float(lv))
    set_mesh(None)
    state = {f"gpt.{k[2:]}": np.asarray(v) for k, v in st["params"].items()}
    return losses, _params(tiny_lm(state))


def test_sp_train_step_of_a_ring_gpt_matches_jax(ranks):
    inp, job = ranks
    losses, params = _jax_sp_step(inp)
    for got in job.wait():
        np.testing.assert_allclose(got["sp.losses"], losses, **STEP)
        for k, want in params.items():
            np.testing.assert_allclose(got[f"sp.p.{k}"], want, **STEP,
                                       err_msg=k)


def test_sp_step_refuses_whole_sequence_attention(ranks):
    """The JAX step computes the global function whatever the model does
    (GSPMD); the port's rank sees its sequence shard, so a model that
    attends through `scaled_dot_product_attention` there is refused, with
    the layer named, before any update."""
    _, job = ranks
    for got in job.wait():
        msg = str(got["refused"])
        assert "gpt.blocks.0.attn" in msg and "use_ring=True" in msg, msg
