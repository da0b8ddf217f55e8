"""paddle_tpu_torch's pipeline held to paddle_tpu's on the 8-virtual-device
CPU mesh.

The port runs gloo ranks (`torch_dist_ranks.py` job "pipeline": one spawn
of 2 ranks, pp 2 x dp 1, and one of 4, pp 2 x dp 2, started together);
the JAX side runs `make_pipeline_train_step` on the same meshes of virtual
devices, from the same weights and batch (`tests/test_pipeline_hetero.py:
33-107`'s GPT and loss), GPipe with and without `recompute` and 1F1B, 3
SGD steps (the port's two GPipe forms against the JAX GPipe of the same
mesh): per-step losses and every updated parameter within rtol 1e-5
(the JAX state's stacked "pp::" blocks read back through
`load_reference_state`). Also the homogeneous `gpipe_spmd` and its
gradient, `partition_blocks` refusing an indivisible stack, and the
parameters a pp rank holds.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.ops.manipulation import reshape
from paddle_tpu.parallel import (create_mesh, make_pipeline_train_step,
                                 set_mesh)
from paddle_tpu.parallel.pipeline import gpipe_spmd

from torch_dist_ranks import _params, _pipeline_cases, start_ranks, tiny_lm

STEP = dict(rtol=1e-5, atol=1e-7)


def _cfg():
    return GPTConfig.tiny(vocab_size=128, num_layers=4, hidden_size=32,
                          num_heads=2, intermediate_size=64,
                          max_position_embeddings=32, dropout=0.0)


def _inputs():
    rng = np.random.RandomState(0)
    a = {"ids": rng.randint(0, 128, size=(8, 16)).astype("int64"),
         "tgt": rng.randint(0, 128, size=(8, 16)).astype("int64"),
         "W": (rng.randn(2, 16, 16) * 0.3).astype("float32"),
         "x": rng.randn(4, 2, 16).astype("float32"),
         "dy": rng.randn(4, 2, 16).astype("float32")}
    paddle.seed(42)
    for k, v in GPTForCausalLM(_cfg()).state_dict().items():
        a[f"gpt.{k}"] = v.numpy()
    return a


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("pipeline")
    inp = _inputs()
    np.savez(wd / "in.npz", **inp)
    jobs = {2: start_ranks("pipeline", 2, str(wd)),
            4: start_ranks("pipeline4", 4, str(wd))}
    yield inp, jobs
    for job in jobs.values():
        job.close()


ce = jnn.CrossEntropyLoss()


def _lm_loss(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    b, s, v = out.shape
    return ce(reshape(out, [b * s, v]), reshape(labels[0], [b * s]))


@functools.lru_cache(maxsize=None)
def _jax_pipeline(dp, schedule):
    """The JAX step's losses and parameters (one compile a mesh and
    schedule: its GPipe runs with `recompute` at dp 1 and without at dp 2,
    and the port's GPipe with and without is held to it, as the JAX
    package holds its two GPipe forms to each other,
    `tests/test_pipeline_hetero.py:94-106`)."""
    inp = _inputs()
    recompute = dp == 1
    paddle.seed(42)
    net = GPTForCausalLM(_cfg())
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    mesh = create_mesh({"dp": dp, "pp": 2}, devices=jax.devices()[:2 * dp])
    step, st = make_pipeline_train_step(net, opt, _lm_loss, n_micro=4,
                                        mesh=mesh, schedule=schedule,
                                        recompute=recompute)
    losses = []
    ids, tgt = inp["ids"].astype("int32"), inp["tgt"].astype("int32")
    for _ in range(3):
        st, lv = step(st, (ids,), (tgt,), rng=jax.random.PRNGKey(0))
        losses.append(float(lv))
    set_mesh(None)
    state = {f"gpt.{k}": np.asarray(v) for k, v in st["params"].items()}
    return losses, _params(tiny_lm(state))


@pytest.mark.parametrize("case", [c[0] for c in _pipeline_cases()])
@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_step_matches_jax(ranks, world, case):
    inp, jobs = ranks
    _, schedule, _ = dict((c[0], c) for c in _pipeline_cases())[case]
    losses, params = _jax_pipeline(world // 2, schedule)
    for got in jobs[world].wait():
        np.testing.assert_allclose(got[f"{case}.losses"], losses, **STEP)
        for k, want in params.items():
            np.testing.assert_allclose(got[f"{case}.p.{k}"], want, **STEP,
                                       err_msg=k)


def test_a_pp_rank_holds_the_sections_and_its_stage(ranks):
    """Stage s holds blocks 2s and 2s + 1 (k = 4 / pp) beside the
    embedding and the head (the tied wte once)."""
    _, jobs = ranks
    for got in jobs[4].wait():
        d = int(got["coords"][1])
        held = set(got["gpipe.held"].tolist())
        blocks = {n.split(".")[2] for n in held if n.startswith("gpt.blocks")}
        assert blocks == {str(2 * d), str(2 * d + 1)}, held
        assert {"gpt.wte.weight", "gpt.wpe.weight", "gpt.ln_f.weight",
                "gpt.ln_f.bias"} <= held


def test_gpipe_spmd_and_its_gradient_match_jax(ranks):
    inp, jobs = ranks
    mesh = create_mesh({"pp": 2}, devices=jax.devices()[:2])
    fwd = gpipe_spmd(lambda w, mx: jnp.tanh(mx @ w), mesh, n_micro=4)

    def f(W):
        y = fwd(W, jnp.asarray(inp["x"]))[-1]
        return jnp.sum(y * jnp.asarray(inp["dy"])), y
    (_, y), dW = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(inp["W"]))
    set_mesh(None)
    got = jobs[2].wait()
    for g in got:
        np.testing.assert_allclose(g["gpipe_spmd.y"], np.asarray(y),
                                   rtol=1e-5, atol=1e-6)
    # each pp rank's gradient reaches its own stage's slice
    whole = sum(g["gpipe_spmd.dW"] for g in got)
    np.testing.assert_allclose(whole, np.asarray(dW), rtol=1e-5, atol=1e-6)


def test_partition_blocks_rejects_indivisible():
    from paddle_tpu_torch.parallel.pipeline import partition_blocks
    m = tiny_lm(_inputs())
    with pytest.raises(ValueError):
        partition_blocks(m.gpt.blocks, 3)
    stages, k = partition_blocks(m.gpt.blocks, 2)
    assert k == 2 and [len(s) for s in stages] == [2, 2]
    assert stages[1][0] is m.gpt.blocks[2]
