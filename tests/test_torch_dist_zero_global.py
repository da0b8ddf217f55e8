"""paddle_tpu_torch's global views under ZeRO and in the pipeline, held to
paddle_tpu's steps on the 8-virtual-device CPU mesh.

The port runs 2 gloo ranks twice (`torch_dist_ranks.py` jobs
"zero_global", dp 2, and "pipeline_clip", pp 2); the JAX package runs
`make_sharded_train_step` / `make_pipeline_train_step` on a mesh of 2
virtual devices, from the same weights and batch, 3 steps:
- `ClipGradByGlobalNorm` under ZeRO-2 and ZeRO-3 (the norm of the whole
  gradient from the ranks' blocks), Lamb and LarsMomentum under ZeRO-1
  and ZeRO-2 (their trust ratios from whole-parameter norms), DGC under
  ZeRO-2 (the whole gradient's top-k from the ranks' blocks), against
  the JAX step at the same stage (stage 0 for the port's ZeRO-3: C34);
- real ZeRO-3: the layer holds no parameter bytes between steps, the
  state a rank's half, the layer's state dict the whole parameters; its blocks and the MoE GPT's 'ep' experts through
  the sharded checkpoint, world 2 -> 1 and 1 -> 2, exact;
- the pipeline's clip at pp 2 (GPipe, the norm over both stages, the
  tied embedding once) in fp32 and under O1 (bfloat16), against the JAX
  pipeline step under the same clip and AMP.
Losses within rtol 2e-4 / atol 2e-5, parameters within rtol 1e-4 / atol
1e-5 (`tests/test_torch_dist_train.py`); under O1 the losses within
`chip_smoke.py` phase 6's 1e-3 and each parameter's update within 2.5e-2
of its largest plus 1e-3 of the model's largest.
"""
import json

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.ops.manipulation import reshape
from paddle_tpu.parallel import (create_mesh, make_pipeline_train_step,
                                 make_sharded_train_step, mesh_scope,
                                 set_mesh, write_back)

from torch_dist_ranks import _mlp, _params, moe_gpt, start_ranks, tiny_lm

LOSS = dict(rtol=2e-4, atol=2e-5)
PARAM = dict(rtol=1e-4, atol=1e-5)
CLIP = 0.1


def _moe_cfg():
    return GPTConfig.tiny(use_moe=True, num_experts=4,
                          max_position_embeddings=32, dropout=0.0)


def _pp_cfg():
    """`tests/test_torch_dist_pipeline.py`'s GPT (`torch_dist_ranks.
    tiny_lm`)."""
    return GPTConfig.tiny(vocab_size=128, num_layers=4, hidden_size=32,
                          num_heads=2, intermediate_size=64,
                          max_position_embeddings=32, dropout=0.0)


def _jax_mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))


def _inputs():
    rng = np.random.RandomState(0)
    a = {"x": rng.randn(16, 8).astype("float32"),
         "y": rng.randint(0, 4, 16).astype("int64"),
         "m_ids": rng.randint(0, 500, size=(4, 32)).astype("int64"),
         "m_tgt": rng.randint(0, 500, size=(4, 32)).astype("int64"),
         "ids": rng.randint(0, 128, size=(8, 16)).astype("int64"),
         "tgt": rng.randint(0, 128, size=(8, 16)).astype("int64"),
         "clip": np.asarray(0.5, "float32")}
    a.update({f"w.{k}": v.numpy() for k, v in _jax_mlp().state_dict().items()})
    paddle.seed(3)
    for k, v in GPTForCausalLM(_moe_cfg()).state_dict().items():
        a[f"moe.{k}"] = v.numpy()
    paddle.seed(42)
    for k, v in GPTForCausalLM(_pp_cfg()).state_dict().items():
        a[f"gpt.{k}"] = v.numpy()
    return a


def _world1_checkpoints(wd, inp):
    """The world-1 states the ranks load under their blocks: the MLP at
    ZeRO-3 after 2 Adam steps, the MoE GPT after 1."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.framework.sharded_checkpoint import save_sharded
    from paddle_tpu_torch.parallel import make_sharded_train_step as mk
    from torch_dist_ranks import lm_loss
    net = _mlp(inp, "w.")
    ce = nn.CrossEntropyLoss()
    step, st = mk(net, ptt.optimizer.Adam(0.01, parameters=net.parameters()),
                  lambda o, lb: ce(o, lb[0]), zero_stage=3)
    for _ in range(2):
        st, _ = step(st, (inp["x"],), (inp["y"],))
    save_sharded(st, str(wd / "z3ck1"), shardings=step.state_sharding)
    m = moe_gpt(inp)
    step, st = mk(m, ptt.optimizer.Adam(1e-3, parameters=m.parameters()),
                  lm_loss)
    st, _ = step(st, (inp["m_ids"][:4],), (inp["m_tgt"][:4],))
    save_sharded(st, str(wd / "epck1"), shardings=step.state_sharding)
    return _params(net), _params(m)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("zero_global")
    inp = _inputs()
    np.savez(wd / "in.npz", **inp)
    w1 = _world1_checkpoints(wd, inp)
    jobs = {"zero": start_ranks("zero_global", 2, str(wd)),
            "pp": start_ranks("pipeline_clip", 2, str(wd))}
    yield wd, inp, w1, jobs
    for job in jobs.values():
        job.close()


ce = jnn.CrossEntropyLoss()


def _mlp_loss(o, lb):
    return ce(o[0] if isinstance(o, (list, tuple)) else o, lb[0])


def _jax_run(opt_name, lr, zero_stage, clip=None, level=None, **kw):
    x, y = _inputs()["x"], _inputs()["y"]
    net = _jax_mlp()
    opt = getattr(paddle.optimizer, opt_name)(
        lr, parameters=net.parameters(),
        grad_clip=None if clip is None else jnn.ClipGradByGlobalNorm(clip))
    with mesh_scope(create_mesh({"dp": 2}, devices=jax.devices()[:2])):
        if level:
            net, opt = paddle.distributed.group_sharded_parallel(net, opt,
                                                                  level)
        step, st = make_sharded_train_step(net, opt, _mlp_loss,
                                           zero_stage=zero_stage, **kw)
        losses = []
        for _ in range(3):
            st, lv = step(st, (x,), (y,), rng=jax.random.PRNGKey(0))
            losses.append(float(lv))
        write_back(net, st)
    set_mesh(None)
    return losses, {k: v.numpy() for k, v in net.state_dict().items()}, st


def _check(got, tag, losses, params):
    for g in got:
        np.testing.assert_allclose(g[f"{tag}.losses"], losses, **LOSS)
        for k, want in params.items():
            mine = g[f"{tag}.{k}"]
            mine = mine.T if k.endswith("weight") else mine
            np.testing.assert_allclose(mine, want, **PARAM, err_msg=k)


@pytest.mark.parametrize("stage", [2, 3])
def test_clip_by_global_norm_under_zero(ranks, stage):
    """ClipGradByGlobalNorm(0.1) with Momentum at ZeRO-2 (the gradients
    reduce-scattered into blocks) and ZeRO-3 (the parameters too): the
    clip scales by the whole gradient's norm, as the JAX step's global
    function does."""
    _, _, _, jobs = ranks
    losses, params, _ = _jax_run("Momentum", 0.1, 2 if stage == 2 else 0,
                                 clip=CLIP)
    got = jobs["zero"].wait()
    _check(got, f"clip{stage}", losses, params)
    # the clip bites: without it the first step moves further
    unclipped, _, _ = _jax_run("Momentum", 0.1, 0)
    assert abs(unclipped[1] - losses[1]) > 1e-4


def test_real_zero3_matches_jax_and_frees_the_layer(ranks):
    """group_sharded_parallel('p_g_os') with Adam: the JAX step (at stage
    0, C34) trains the same values; between steps the layer's parameters
    hold no storage and the state holds half the parameter bytes."""
    _, _, _, jobs = ranks
    losses, params, _ = _jax_run("Adam", 0.01, 0, level="p_g_os")
    got = jobs["zero"].wait()
    _check(got, "z3", losses, params)
    full = sum(v.nbytes for v in params.values())
    for g in got:
        assert int(g["z3.layer_bytes"]) == 0
        assert int(g["z3.state_bytes"]) * 2 == full
        # the layer's state dict, read between steps, is the whole model
        # and leaves the layer empty
        assert int(g["z3.layer_bytes_after_sd"]) == 0
        for k in params:
            np.testing.assert_array_equal(g[f"z3.sd.{k}"], g[f"z3.{k}"])


@pytest.mark.parametrize("name", ["Lamb", "LarsMomentum"])
@pytest.mark.parametrize("stage", [1, 2])
def test_whole_norm_rules_under_zero(ranks, name, stage):
    """Lamb's trust ratio and LarsMomentum's local rate read whole-
    parameter norms: each rank's block sums its squares over dp."""
    _, _, _, jobs = ranks
    losses, params, _ = _jax_run(name, 0.1, stage)
    _check(jobs["zero"].wait(), f"{name}{stage}", losses, params)


def test_dgc_under_zero2(ranks):
    """dgc=True at ZeRO-2, sparsity 0.75: the top-k of each whole
    gradient from the ranks' blocks; the error-feedback state v, each
    rank's block of it, reassembles the JAX step's."""
    _, _, _, jobs = ranks
    losses, params, st = _jax_run("SGD", 0.1, 2, dgc=True,
                                  dgc_sparsity=0.75)
    got = jobs["zero"].wait()
    _check(got, "dgc2", losses, params)
    axes = json.loads(str(got[0]["zero_axes"]))
    for k, ax in axes.items():
        whole = np.concatenate([g[f"dgc2.v.{k}"] for g in got], ax)
        whole = whole.T if k.endswith("weight") else whole
        np.testing.assert_allclose(whole, np.asarray(st["dgc"][k]["v"]),
                                   **PARAM, err_msg=k)


def test_zero3_blocks_sharded_checkpoint(ranks):
    """ZeRO-3's parameter blocks saved at world 2 load whole at world 1
    (the written-back parameters), and a world-1 save loads as each
    rank's block."""
    from paddle_tpu_torch.framework.sharded_checkpoint import load_sharded
    wd, _, (w1_mlp, _), jobs = ranks
    got = jobs["zero"].wait()
    back = load_sharded(str(wd / "z3ck2"))
    assert back["step_no"] == 3
    axes = json.loads(str(got[0]["zero_axes"]))
    for k, v in back["params"].items():
        np.testing.assert_array_equal(v.numpy(), got[0][f"z3.{k}"])
        for r, g in enumerate(got):
            np.testing.assert_array_equal(
                g[f"z3ck1.{k}"], np.split(w1_mlp[k], 2, axes[k])[r])


def test_moe_ep_shards_sharded_checkpoint(ranks):
    """The MoE GPT's experts, a block of 2 of 4 a rank on {ep 2}, saved at
    world 2 load whole at world 1; a world-1 save loads as each rank's
    experts."""
    from paddle_tpu_torch.framework.sharded_checkpoint import load_sharded
    wd, _, (_, w1_moe), jobs = ranks
    got = jobs["zero"].wait()
    back = load_sharded(str(wd / "epck2"))
    for k, v in back["params"].items():
        if ".mlp.w_" in k:
            want = np.concatenate([g[f"epck2.{k}"] for g in got], 0)
            assert want.shape[0] == 4
            for r, g in enumerate(got):
                np.testing.assert_array_equal(g[f"epck1.{k}"],
                                              w1_moe[k][2 * r:2 * r + 2])
        else:
            want = got[0][f"epck2.{k}"]
            np.testing.assert_array_equal(got[1][f"epck2.{k}"], want)
            np.testing.assert_array_equal(got[0][f"epck1.{k}"], w1_moe[k])
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def _lm_loss(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    b, s, v = out.shape
    return jnn.CrossEntropyLoss()(reshape(out, [b * s, v]),
                                  reshape(labels[0], [b * s]))


def _jax_pipeline(amp_level):
    inp = _inputs()
    paddle.seed(42)
    net = GPTForCausalLM(_pp_cfg())
    opt = paddle.optimizer.SGD(
        0.1, parameters=net.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(float(inp["clip"])))
    mesh = create_mesh({"pp": 2}, devices=jax.devices()[:2])
    step, st = make_pipeline_train_step(net, opt, _lm_loss, n_micro=4,
                                        mesh=mesh, recompute=False)
    losses = []
    ids, tgt = inp["ids"].astype("int32"), inp["tgt"].astype("int32")
    for _ in range(3):
        if amp_level:
            with paddle.amp.auto_cast(level=amp_level):
                st, lv = step(st, (ids,), (tgt,), rng=jax.random.PRNGKey(0))
        else:
            st, lv = step(st, (ids,), (tgt,), rng=jax.random.PRNGKey(0))
        losses.append(float(lv))
    set_mesh(None)
    state = {f"gpt.{k}": np.asarray(v) for k, v in st["params"].items()}
    return losses, _params(tiny_lm(state))


@pytest.mark.parametrize("tag", ["fp32", "o1"])
def test_pipeline_clip_and_amp_match_jax(ranks, tag):
    """GPipe at pp 2 with ClipGradByGlobalNorm(0.5): the norm over both
    stages' gradients (the embedding and head once), fp32 and O1."""
    _, inp, _, jobs = ranks
    losses, params = _jax_pipeline("O1" if tag == "o1" else None)
    init = _params(tiny_lm(inp))
    floor = max(np.abs(params[k] - init[k]).max() for k in params)
    for g in jobs["pp"].wait():
        if tag == "fp32":
            np.testing.assert_allclose(g[f"{tag}.losses"], losses, **LOSS)
        else:
            np.testing.assert_allclose(g[f"{tag}.losses"], losses,
                                       rtol=1e-3)
        for k, want in params.items():
            d, dw = g[f"{tag}.p.{k}"] - init[k], want - init[k]
            if tag == "fp32":
                np.testing.assert_allclose(g[f"{tag}.p.{k}"], want, **PARAM,
                                           err_msg=k)
            else:
                assert np.abs(d - dw).max() <= (
                    2.5e-2 * np.abs(dw).max() + 1e-3 * floor), k
