"""paddle_tpu_torch's hybrid parallelism held to paddle_tpu's sharded step
on the 8-virtual-device CPU mesh: ERNIE through `tp_annotate` at dp 2 x
mp 2 with ZeRO-1 and recompute (`__graft_entry__.py` phase 1), the MoE
GPT at dp 2 x ep 2 (its phase 3), and the dropout of a tensor-parallel
attention.

The port runs 4 gloo ranks (`torch_dist_ranks.py` job "hybrid") and 2
(job "tp_dropout"); the JAX package runs `make_sharded_train_step` on a
{dp 2, mp 2} and a {dp 2, ep 2} mesh of virtual devices, from the same
weights (the JAX models', carried by `load_reference_state`, each rank
cutting its slice) and the same global batch, dropout 0, 3 steps: every
rank's losses within rtol 2e-4 / atol 2e-5 and each parameter,
reassembled from the ranks' slices by its `partition_spec`, within rtol
1e-4 / atol 1e-5 (`tests/test_torch_dist_train.py`'s LOSS and PARAM).
Adam's `k_proj.bias` has an exactly-zero true gradient, so its update is
rounding noise and is not compared. The tp 2 dropout arm (attention and
hidden dropout 0.1, the flash path's plain versions at S 128) is held to
the same model at world 1 here: the keep masks are keyed on the global
head, so tp 2 draws tp 1's.
"""
import json

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import (ErnieConfig, ErnieForSequenceClassification,
                               GPTConfig, GPTForCausalLM, tp_annotate)
from paddle_tpu.ops.manipulation import reshape
from paddle_tpu.parallel import (create_mesh, make_sharded_train_step,
                                 mesh_scope, set_mesh, write_back)

from torch_dist_ranks import _params, ernie_cls, start_ranks

LOSS = dict(rtol=2e-4, atol=2e-5)
PARAM = dict(rtol=1e-4, atol=1e-5)
NOISE = ("k_proj.bias",)


def _ernie_cfg(p=0.0):
    cfg = ErnieConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = p
    return cfg


def _moe_cfg():
    return GPTConfig.tiny(use_moe=True, num_experts=4,
                          max_position_embeddings=32, dropout=0.0)


def _inputs():
    rng = np.random.RandomState(0)
    a = {"e_ids": rng.randint(0, 1000, size=(4, 16)).astype("int64"),
         "e_labels": rng.randint(0, 4, size=(4,)).astype("int64"),
         "m_ids": rng.randint(0, 500, size=(4, 32)).astype("int64"),
         "m_tgt": rng.randint(0, 500, size=(4, 32)).astype("int64"),
         "d_ids": rng.randint(0, 1000, size=(2, 128)).astype("int64"),
         "d_labels": rng.randint(0, 4, size=(2,)).astype("int64")}
    paddle.seed(1)
    for k, v in ErnieForSequenceClassification(
            _ernie_cfg(), num_classes=4).state_dict().items():
        a[f"ernie.{k}"] = v.numpy()
    paddle.seed(3)
    for k, v in GPTForCausalLM(_moe_cfg()).state_dict().items():
        a[f"moe.{k}"] = v.numpy()
    return a


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("hybrid")
    inp = _inputs()
    np.savez(wd / "in.npz", **inp)
    jobs = {"hybrid": start_ranks("hybrid", 4, str(wd)),
            "tp_dropout": start_ranks("tp_dropout", 2, str(wd))}
    yield inp, jobs
    for job in jobs.values():
        job.close()


ce = jnn.CrossEntropyLoss()


def _cls_loss(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    return ce(out, labels[0])


def _lm_loss(outs, labels):
    out = outs[0] if isinstance(outs, (list, tuple)) else outs
    b, s, v = out.shape
    return ce(reshape(out, [b * s, v]), reshape(labels[0], [b * s]))


def _jax_run(net, opt, loss, mesh_axes, ins, lbs, **kw):
    with mesh_scope(create_mesh(mesh_axes, devices=jax.devices()[:4])):
        step, st = make_sharded_train_step(net, opt, loss, **kw)
        losses = []
        for _ in range(3):
            st, lv = step(st, ins, lbs, rng=jax.random.PRNGKey(0))
            losses.append(float(lv))
        write_back(net, st)
    set_mesh(None)
    return losses, {k: v.numpy() for k, v in net.state_dict().items()}


def _linear_names(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _whole(ranks, prefix, k, specs, axis, group_of):
    """Parameter k reassembled from the ranks of one group (dp
    coordinate 0) along its `axis`-split dim."""
    rows = sorted((g for g in ranks if group_of(g)[0] == 0),
                  key=lambda g: group_of(g)[1])
    spec = specs.get(k)
    if spec is None or axis not in spec:
        return rows[0][f"{prefix}{k}"]
    return np.concatenate([g[f"{prefix}{k}"] for g in rows],
                          spec.index(axis))


def test_ernie_tp_annotate_dp2_mp2_matches_jax(ranks):
    """Phase 1: ERNIE-tiny through tp_annotate on {dp 2, mp 2}, ZeRO-1,
    recompute, AdamW 1e-4: each rank holds 2 of the 4 heads and its
    slices of q/k/v, linear1 (rows), out_proj, linear2 (columns) and
    the word embeddings (rows)."""
    inp, jobs = ranks
    paddle.seed(1)
    net = ErnieForSequenceClassification(_ernie_cfg(), num_classes=4)
    tp_annotate(net)
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())
    losses, params = _jax_run(
        net, opt, _cls_loss, {"dp": 2, "mp": 2},
        (inp["e_ids"].astype("int32"),), (inp["e_labels"].astype("int32"),),
        zero_stage=1, recompute=True)
    got = jobs["hybrid"].wait()
    specs = json.loads(str(got[0]["ernie.specs"]))
    assert specs["ernie.encoder.layers.0.self_attn.q_proj.weight"] == \
        ["mp", None]
    assert specs["ernie.encoder.layers.0.linear2.weight"] == [None, "mp"]
    assert specs["ernie.embeddings.word_embeddings.weight"] == ["mp", None]
    assert all(int(g["ernie.local_heads"]) == 2 for g in got)
    for g in got:
        np.testing.assert_allclose(g["ernie.losses"], losses, **LOSS)
    linear = _linear_names(ernie_cls(inp, {}))
    for k, want in params.items():
        if k.endswith(NOISE):
            continue
        for dp in (0, 1):
            whole = _whole(got, "ernie.p.", k, specs, "mp",
                           lambda g: (int(g["coords"][0]) - dp,
                                      int(g["coords"][1])))
            whole = whole.T if k in linear else whole
            np.testing.assert_allclose(whole, want, **PARAM, err_msg=k)
    assert losses[2] < losses[0]


def test_moe_dp2_ep2_matches_jax(ranks):
    """Phase 3: the 4-expert GPT on {dp 2, ep 2}, Adam 1e-4: a rank holds
    2 experts ([2, d, f] and [2, f, d], spec ("ep", None, None)), the
    gate whole; the routing (top-1 of the gate) is the same in both
    packages on this batch."""
    inp, jobs = ranks
    paddle.seed(3)
    net = GPTForCausalLM(_moe_cfg())
    opt = paddle.optimizer.Adam(1e-4, parameters=net.parameters())
    losses, params = _jax_run(
        net, opt, _lm_loss, {"dp": 2, "ep": 2},
        (inp["m_ids"].astype("int32"),), (inp["m_tgt"].astype("int32"),))
    got = jobs["hybrid"].wait()
    specs = json.loads(str(got[0]["moe.specs"]))
    assert set(specs) == {f"gpt.blocks.{i}.mlp.{w}" for i in range(2)
                          for w in ("w_up", "w_down")}
    assert all(v == ["ep", None, None] for v in specs.values())
    up = got[0]["moe.p.gpt.blocks.0.mlp.w_up"]
    assert up.shape[0] == 2 == params["gpt.blocks.0.mlp.w_up"].shape[0] // 2
    for g in got:
        np.testing.assert_allclose(g["moe.losses"], losses, **LOSS)
    from paddle_tpu_torch.models import GPTConfig as TConfig
    from paddle_tpu_torch.models import GPTForCausalLM as TGPT
    linear = _linear_names(TGPT(TConfig.tiny(use_moe=True, num_experts=4,
                                             max_position_embeddings=32),
                                device="cpu"))
    for k, want in params.items():
        if k.endswith(NOISE):
            continue
        for dp in (0, 1):
            whole = _whole(got, "moe.p.", k, specs, "ep",
                           lambda g: (int(g["moe.coords"][0]) - dp,
                                      int(g["moe.coords"][1])))
            whole = whole.T if k in linear else whole
            np.testing.assert_allclose(whole, want, **PARAM, err_msg=k)


def test_moe_expert_gradients_reduce_over_dp_only(ranks):
    """The experts' ZeRO blocks split over dp (their free dims), never the
    'ep' dim; the ranks of one ep coordinate hold equal experts."""
    _, jobs = ranks
    got = jobs["hybrid"].wait()
    axes = json.loads(str(got[0]["moe.zero_axes"]))
    assert axes["gpt.blocks.0.mlp.w_up"] in (1, 2)
    by_ep = {}
    for g in got:
        by_ep.setdefault(int(g["moe.coords"][1]), []).append(
            g["moe.p.gpt.blocks.0.mlp.w_up"])
    for a, b in by_ep.values():
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(by_ep[0][0], by_ep[1][0])


@pytest.mark.parametrize("p", ["p0", "p1"])
def test_tp2_dropout_equals_tp1(ranks, p):
    """ERNIE-tiny at S 128 (the flash path's plain versions), mp 2
    against world 1, 2 SGD steps from one rng: with dropout 0.1 in the
    attention and the hidden states the losses and the reassembled
    parameters are tp 1's, because the attention's keep mask is keyed on
    the global head."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.framework.flags import get_flags, set_flags
    from paddle_tpu_torch.models import tp_annotate as ttp
    from paddle_tpu_torch.parallel import make_sharded_train_step as mk
    inp, jobs = ranks
    old = get_flags("FLAGS_flash_attention_min_seq")
    set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        rate = 0.1 if p == "p1" else 0.0
        net = ttp(ernie_cls(inp, dict(hidden_dropout_prob=rate,
                                      attention_probs_dropout_prob=rate)))
        tce = nn.CrossEntropyLoss()
        step, st = mk(net, ptt.optimizer.SGD(0.1,
                                             parameters=net.parameters()),
                      lambda o, lb: tce(o, lb[0]), zero_stage=0)
        losses = []
        for i in range(2):
            st, lv = step(st, (inp["d_ids"],), (inp["d_labels"],),
                          rng=5 + i)
            losses.append(float(lv))
    finally:
        set_flags(old)
    want = _params(net)
    got = jobs["tp_dropout"].wait()
    specs = {n: list(q.partition_spec) for n, q in net.named_parameters()
             if getattr(q, "partition_spec", None)}
    for g in got:
        np.testing.assert_allclose(g[f"{p}.losses"], losses, **LOSS)
    for k, w in want.items():
        spec = specs.get(k)
        whole = (np.concatenate([g[f"{p}.p.{k}"] for g in got],
                                spec.index("mp"))
                 if spec else got[0][f"{p}.p.{k}"])
        np.testing.assert_allclose(whole, w, **PARAM, err_msg=k)
    if p == "p1":
        assert not np.allclose(got[0]["p0.losses"], losses)


def test_tp2_keep_masks_reassemble_tp1(ranks):
    """`_keep_mask` of a rank holding heads [2r, 2r + 2) of 4 (its
    `head_shard`) is that slice of the 4-head mask; the local-head key
    (the mask of both ranks before the repair) is neither rank's."""
    from paddle_tpu_torch.ops import flash_ops
    _, jobs = ranks
    got = jobs["tp_dropout"].wait()
    whole = flash_ops._keep_mask(1234, 2, 4, 128, 128, 0.3, "cpu").numpy()
    np.testing.assert_array_equal(
        np.concatenate([g["mask"] for g in got], 1), whole)
    local = flash_ops._keep_mask(1234, 2, 2, 128, 128, 0.3, "cpu").numpy()
    assert not np.array_equal(got[0]["mask"], got[1]["mask"])
    assert not any(np.array_equal(g["mask"], local) for g in got)


@pytest.mark.parametrize("case, words", [
    ("vocab", "does not split on dim 0"),
    ("column", "does not split on dim 0"),
    ("row", "does not split on dim 1"),
    ("partial", "together or not at all"),
    ("act_dropout", "act_dropout=0")])
def test_shard_megatron_refuses_what_tp1_would_not_compute(ranks, case,
                                                           words):
    """At mp 2, `shard_megatron` (and `tp_annotate`) raise
    InvalidArgumentError, cutting nothing, where a marked vocabulary or
    Linear dim does not split (11 rows, 5 outputs, 5 inputs), where an
    attention is marked in part (only q_proj), and where a Transformer
    layer's activation dropout (0.1, its default: `dropout`) would run on
    linear1's column slice with every rank's mask alike."""
    _, jobs = ranks
    for g in jobs["tp_dropout"].wait():
        assert words in str(g[f"mt.{case}"]), str(g[f"mt.{case}"])
        assert bool(g[f"mt.{case}.whole"])


def test_shard_megatron_cuts_what_splits_and_leaves_plain_attention(ranks):
    """An encoder layer with attention dropout and act_dropout 0 is cut;
    an attention none of whose projections is marked stays whole beside a
    marked Linear (cut to 2 of 4 outputs) and computes what it did."""
    _, jobs = ranks
    for g in jobs["tp_dropout"].wait():
        assert str(g["mt.act_dropout0"]) == ""
        assert not bool(g["mt.act_dropout0.whole"])
        assert str(g["mt.plain_attn.tp"]) == "None"
        assert float(g["mt.plain_attn.err"]) == 0.0
        assert int(g["mt.plain_attn.fc_out"]) == 2
