"""paddle_tpu_torch.ops.extra_ops held to paddle_tpu.ops.extra_ops: the
38 names this slice ports (the rest of the reference's `__all__`).

- `test_op_and_gradients_match_jax`: every differentiable op on the same
  seeded numpy inputs in both packages: the outputs within 1e-5 x max(1,
  max |ref|), integers exactly, the JAX package's types
  (`torch_ops_parity.compare`); and the gradient of sum(first output *
  w) (w standard normal, seed 1) for every float32 input, within the
  same limit. The JAX side of every case runs under one `jax.jit`
  (`jax_jit_grads_many`).
- `test_host_op_matches_jax`: the ops the JAX package runs on the host
  (`filter_by_instag`, `var_conv_2d`), forward, with their LoD offsets.
- The ops that draw (`nce`, `sample_logits`, `shuffle_batch`) cannot
  match the JAX package's bits (another generator): each is held where
  the draw cannot change the result (one class for `nce` and
  `sample_logits`), and its draw by range, shape, type and the
  permutation property, with a seed that replays.
- `test_every_name_has_a_case` keeps the cases whole, and the
  re-exports (`nn.functional`, `ops.legacy`, the top level,
  `incubate`) are the module's functions.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.ops import extra_ops as JX
from paddle_tpu_torch.ops import extra_ops as TX
from torch_ops_parity import (compare, jax_jit_grads_many,  # noqa: F401
                              on_the_cpu, r, ri)

TOL = 1e-5
F32 = np.float32

SEG = np.array([0, 0, 1, 3, 3, 3], np.int32)
FEAT = r(50, 2, 3, 8, 8)
# x1, y1, x2, y2 in input pixels (spatial_scale 0.5 maps them onto FEAT)
ROIS = np.array([[1.0, 2.0, 9.0, 13.0], [0.0, 0.0, 15.0, 15.0],
                 [4.5, 3.0, 7.5, 11.0], [2.0, 6.0, 14.0, 9.0]], F32)
ROIS_NUM = np.array([3, 1], np.int32)
EDGES = np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [0, 0]],
                  [[2, 0], [2, 1], [0, 3], [0, 0], [0, 0]]], np.int32)
RANK_OFF = np.array([[1, 1, 0, 2, 1, 0, 0],
                     [2, 1, 0, 3, 2, 0, 0],
                     [0, 1, 1, 0, 0, 0, 0],
                     [3, 3, 3, 2, 1, 1, 2]], np.int32)
PROB = np.random.RandomState(51).dirichlet(np.ones(5), 4).astype(F32)
Y01 = (r(52, 4, 1, lo=0, hi=1) > 0.5).astype(F32)

CASES = {
    "temporal_shift": ((r(0, 4, 8, 3, 3), 2), {}),
    "temporal_shift#nhwc": ((r(1, 4, 3, 3, 8), 2),
                            {"shift_ratio": 0.2, "data_format": "NHWC"}),
    "segment_sum": ((r(2, 6, 3), SEG), {}),
    "segment_mean": ((r(2, 6, 3), SEG), {}),
    "segment_max": ((r(2, 6, 3), SEG), {}),
    "segment_min": ((r(2, 6, 3), SEG), {"num_segments": 5}),
    "segment_sum#int": ((ri(3, 6, 3), SEG), {"num_segments": 5}),
    "segment_max#int": ((ri(3, 6, 3), SEG), {"num_segments": 5}),
    "affine_channel": ((r(4, 2, 4, 3, 3), r(5, 4), r(6, 4)), {}),
    "affine_channel#nhwc": ((r(4, 2, 3, 3, 4), r(5, 4), r(6, 4)),
                            {"data_layout": "NHWC"}),
    "row_conv": ((r(7, 2, 5, 3), r(8, 3, 3)), {}),
    "conv_shift": ((r(9, 3, 7), r(10, 3, 3)), {}),
    "cvm": ((r(11, 4, 5, lo=0, hi=3), r(12, 4, 2)), {}),
    "cvm#strip": ((r(11, 4, 5, lo=0, hi=3), r(12, 4, 2)),
                  {"use_cvm": False}),
    "data_norm": ((r(13, 4, 3), np.full(3, 10.0, F32), r(14, 3),
                   r(15, 3, lo=20, hi=30)), {}),
    "space_to_depth": ((r(16, 2, 3, 4, 4), 2), {}),
    "pad_constant_like": ((r(17, 4, 5), r(18, 2, 3)), {"pad_value": 1.5}),
    "partial_concat": (([r(19, 3, 5), r(20, 3, 5)],),
                       {"start_index": 1, "length": 2}),
    "partial_sum": (([r(19, 3, 5), r(20, 3, 5), r(21, 3, 5)],),
                    {"start_index": 2}),
    "l1_norm": ((r(22, 3, 4),), {}),
    "squared_l2_norm": ((r(22, 3, 4),), {}),
    "rank_loss": ((Y01, r(23, 4, 1), r(24, 4, 1)), {}),
    "bpr_loss": ((r(25, 4, 5), ri(26, 4, 1, hi=5)), {}),
    "center_loss": ((r(27, 4, 3), np.array([[0], [2], [0], [1]], np.int32),
                     r(28, 3, 3)), {"alpha": 0.2}),
    "center_loss#fixed": ((r(27, 4, 3), np.array([[0], [2], [0], [1]],
                                                 np.int32), r(28, 3, 3)),
                          {"update_center": False}),
    "hinge_loss": ((r(29, 4, 1), Y01), {}),
    "im2sequence": ((r(30, 2, 2, 5, 5),),
                    {"filter_size": 3, "stride": 2, "padding": 1}),
    "linear_chain_crf": ((r(31, 2, 5, 3), r(32, 5, 3),
                          ri(33, 2, 5, hi=3), np.array([5, 3], np.int32)),
                         {}),
    "roi_pool": ((FEAT, ROIS, ROIS_NUM, 2), {"spatial_scale": 0.5}),
    "roi_pool#bins": ((FEAT, ROIS, ROIS_NUM, (3, 2)),
                      {"spatial_scale": 0.5}),
    "fsp": ((r(34, 2, 3, 4, 4), r(35, 2, 2, 4, 4)), {}),
    "cross_entropy2": ((PROB, np.array([[1], [4], [-100], [0]], np.int32)),
                       {}),
    "psroi_pool": ((r(36, 2, 8, 8, 8), ROIS, ROIS_NUM, 2, 0.5, 2, 2), {}),
    "prroi_pool": ((FEAT, ROIS, ROIS_NUM, 2), {"spatial_scale": 0.5}),
    "correlation": ((r(37, 1, 3, 5, 5), r(38, 1, 3, 5, 5), 1, 1, 1), {}),
    "deformable_conv": ((r(39, 1, 2, 5, 5), r(40, 1, 18, 5, 5) * F32(0.7),
                         r(41, 3, 2, 3, 3)), {"padding": 1}),
    "deformable_conv#mask": ((r(39, 1, 2, 5, 5), r(40, 1, 18, 5, 5),
                              r(41, 3, 2, 3, 3)),
                             {"padding": 1, "stride": 2,
                              "mask": r(42, 1, 9, 3, 3, lo=0, hi=1)}),
    "nce#one_class": ((r(43, 4, 3), np.zeros((4, 1), np.int32), 1),
                      {"nid_weight": r(44, 1, 3), "bias": r(45, 1),
                       "num_neg_samples": 3}),
    "batch_fc": ((r(46, 2, 3, 4), r(47, 2, 4, 5), r(48, 2, 5)), {}),
    "sample_logits#one_class": ((r(49, 4, 1), np.zeros((4, 1), np.int32),
                                 3), {}),
    "tree_conv": ((r(53, 2, 5, 3), EDGES, r(54, 3, 4, 3)), {}),
    "bilateral_slice": ((r(55, 1, 2, 4, 4), r(56, 1, 4, 4, lo=0, hi=1),
                         r(57, 1, 9, 2, 3, 3)), {}),
    "bilateral_slice#no_offset": ((r(55, 1, 2, 4, 4),
                                   r(56, 1, 4, 4, lo=0, hi=1),
                                   r(58, 1, 6, 2, 3, 3)),
                                  {"has_offset": False}),
    "rank_attention": ((r(59, 4, 3), RANK_OFF, r(60, 27, 2)),
                       {"max_rank": 3}),
}
# a case whose kwargs hold arrays: those arrays are inputs too
ARRAY_KW = ("nid_weight", "bias", "mask")


def _float_pos(args):
    return [i for i, a in enumerate(args)
            if isinstance(a, np.ndarray) and a.dtype == F32]


def _split(name):
    """(positional inputs, the array kwargs' names, other kwargs)."""
    args, kw = CASES[name]
    keys = [k for k in ARRAY_KW if k in kw]
    rest = {k: v for k, v in kw.items() if k not in keys}
    return list(args) + [kw[k] for k in keys], keys, rest


def _fn(mod, name, n_pos, keys, rest, to):
    op = getattr(mod, name.split("#")[0])

    def call(*a):
        kw = dict(rest, **dict(zip(keys, a[n_pos:])))
        return op(*[to(x) for x in a[:n_pos]], **kw)
    return call


def _jx(a):
    return [paddle.to_tensor(x) for x in a] if isinstance(a, list) else a


def _tx(a):
    return [torch.from_numpy(x.copy()) for x in a] if isinstance(a, list) \
        else a


@functools.lru_cache(maxsize=None)
def _jax():
    cases = {}
    for name in CASES:
        inputs, keys, rest = _split(name)
        n_pos = len(CASES[name][0])
        cases[name] = (_fn(paddle.ops.extra_ops, name, n_pos, keys, rest,
                           _jx), inputs, _float_pos(inputs), None, 1)
    return jax_jit_grads_many(cases)


def test_every_name_has_a_case():
    ported = sorted(set(JX.__all__) - {"pixel_unshuffle", "channel_shuffle",
                                       "max_unpool2d", "affine_grid",
                                       "gather_tree"})
    assert len(ported) == 38
    held = {n.split("#")[0] for n in CASES} | {
        "filter_by_instag", "var_conv_2d", "shuffle_batch"}
    assert sorted(held) == ported
    assert sorted(TX.__all__) == sorted(set(JX.__all__))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_and_gradients_match_jax(name):
    inputs, keys, rest = _split(name)
    n_pos = len(CASES[name][0])
    ts = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
          for a in inputs]
    pos = _float_pos(inputs)
    for i in pos:
        ts[i].requires_grad_()
    got = _fn(TX, name, n_pos, keys, rest, _tx)(*ts)
    first = got[0] if isinstance(got, tuple) else got
    w = np.random.RandomState(1).standard_normal(
        tuple(first.shape)).astype(F32)
    if pos:
        (first * torch.from_numpy(w)).sum().backward()
    want, jgrads, _ = _jax()[name]
    compare(name, got, want, TOL)
    assert len(jgrads) == len(pos)
    for i, jg in zip(pos, jgrads):
        g = ts[i].grad if ts[i].grad is not None else torch.zeros_like(ts[i])
        compare(f"{name} grad {i}", g, jg, TOL)


def test_segment_ops_derive_the_count_and_drop_outside_ids():
    d = r(61, 5, 2)
    ids = np.array([3, -1, 0, 3, 9], np.int32)
    for op in ("segment_sum", "segment_mean", "segment_max", "segment_min"):
        want = getattr(JX, op)(paddle.to_tensor(d), paddle.to_tensor(ids),
                               num_segments=4)
        got = getattr(TX, op)(torch.from_numpy(d), torch.from_numpy(ids),
                              num_segments=4)
        compare(op, got, want, TOL)
    got = TX.segment_sum(torch.from_numpy(d), torch.from_numpy(SEG[:5]))
    assert tuple(got.shape) == (4, 2)


def test_host_op_matches_jax():
    from paddle_tpu.ops.legacy import LoDTensor as JLoD
    from paddle_tpu_torch.ops.legacy import LoDTensor as TLoD
    ins = np.arange(8, dtype=F32).reshape(4, 2)
    tags = np.array([1, 2, 3, 2, 9, 4], np.int32)
    offs = [[0, 2, 3, 5, 6]]
    for want_tags in (np.array([2], np.int32), np.array([7], np.int32)):
        want = JX.filter_by_instag(paddle.to_tensor(ins), JLoD(tags, offs),
                                   paddle.to_tensor(want_tags))
        got = TX.filter_by_instag(torch.from_numpy(ins), TLoD(tags, offs),
                                  torch.from_numpy(want_tags))
        compare("filter_by_instag", got, want, 0)
    rows, cols = np.array([4, 6]), np.array([4, 2])
    flat = r(62, 4 * 4 + 6 * 2)
    wgt = r(63, 2, 1, 3, 3)
    want = JX.var_conv_2d(JLoD(flat, [[0, 16, 28]]), paddle.to_tensor(rows),
                          paddle.to_tensor(cols), 1, 2, 3,
                          w=paddle.to_tensor(wgt))
    got = TX.var_conv_2d(TLoD(flat, [[0, 16, 28]]), torch.from_numpy(rows),
                         torch.from_numpy(cols), 1, 2, 3,
                         w=torch.from_numpy(wgt))
    compare("var_conv_2d", got, want, TOL)
    assert got.lod() == want.lod()


def test_draws_by_range_shape_and_replay():
    x = torch.from_numpy(r(64, 6, 3))
    logits = torch.from_numpy(r(65, 4, 7))
    label = torch.from_numpy(ri(66, 4, 1, hi=7))
    a = TX.shuffle_batch(x, seed=3)
    assert torch.equal(a, TX.shuffle_batch(x, seed=3))
    assert any(not torch.equal(TX.shuffle_batch(x, seed=s), a)
               for s in (4, 5))
    assert torch.equal(torch.sort(a, 0).values, torch.sort(x, 0).values)
    want = JX.shuffle_batch(paddle.to_tensor(x.numpy()), seed=3)
    assert want.shape == list(a.shape)
    samp, ids = TX.sample_logits(logits, label, 5, seed=2)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (4, 6)
    assert torch.equal(ids[:, :1], label) and int(ids.min()) >= 0 \
        and int(ids.max()) < 7
    assert torch.equal(samp, torch.gather(logits, 1, ids.long()))
    assert torch.equal(TX.sample_logits(logits, label, 5, seed=2)[1], ids)
    ptt.seed(7)
    one = TX.shuffle_batch(x)
    ptt.seed(7)
    assert torch.equal(TX.shuffle_batch(x), one)
    w, b = torch.from_numpy(r(67, 7, 6)), torch.from_numpy(r(68, 7))
    loss = TX.nce(torch.from_numpy(r(69, 4, 6)), label, 7, nid_weight=w,
                  bias=b, num_neg_samples=4, seed=1)
    assert tuple(loss.shape) == (4, 1) and bool((loss > 0).all())


def test_lazy_parameters_and_static_checks():
    x = torch.from_numpy(r(70, 4, 3))
    out = TX.nce(x, torch.zeros(4, 1, dtype=torch.int32), 5,
                 param_attr="nce_w", bias_attr="nce_b", seed=0)
    again = TX.nce(x, torch.zeros(4, 1, dtype=torch.int32), 5,
                   param_attr="nce_w", bias_attr="nce_b", seed=0)
    assert torch.equal(out, again)
    att = TX.rank_attention(x, torch.from_numpy(RANK_OFF), (27, 2))
    assert tuple(att.shape) == (4, 2)
    with pytest.raises(ValueError):
        TX.rank_attention(x, torch.from_numpy(RANK_OFF[:, :5]), (27, 2))
    with pytest.raises(ValueError):
        TX.rank_attention(x, torch.from_numpy(RANK_OFF),
                          torch.zeros(26, 2))
    with pytest.raises(ValueError):
        TX.bilateral_slice(torch.zeros(1, 2, 4, 4), torch.zeros(1, 4, 4),
                           torch.zeros(1, 8, 2, 3, 3))


def test_reexports():
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import legacy
    assert F.temporal_shift is TX.temporal_shift
    for n in paddle.ops.legacy.__all__:
        if n in JX.__all__:
            assert getattr(legacy, n) is getattr(TX, n), n
            assert getattr(ptt, n) is getattr(TX, n), n
    for n in ("segment_sum", "segment_mean", "segment_max", "segment_min"):
        assert getattr(incubate, n) is getattr(TX, n)
