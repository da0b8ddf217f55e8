"""paddle_tpu_torch.vision.ops held to paddle_tpu.vision.ops: all 12
functions on the same seeded numpy inputs.

- The tensor functions (`box_iou`, `roi_align`, `roi_pool`, `yolo_box`,
  `box_coder`): outputs within 1e-5 x max(1, max |ref|), integers
  exactly, the JAX package's types; and the gradient of sum(first output
  * w) (w standard normal, seed 1) for every float32 input, within the
  same limit (the JAX side under one `jax.jit`). `yolov3_loss` is held
  to the JAX package in `test_torch_yolov3.py`, at the model's shapes.
- `yolov3_loss`'s assignment mask is an OR: a padded gt lands on the
  cell (n, anchor 0, 0, 0) of a real gt, and the real gt keeps it.
- The NMS family (`nms`, `multiclass_nms`, `generate_proposals`) is
  index-exact: the same kept indices, labels and counts, boxes and
  scores within 1e-5. The scores have no ties (numpy's quicksort in the
  JAX package orders ties arbitrarily, the port's sort is stable).
- `anchor_generator`, `prior_box` and `distribute_fpn_proposals` equal
  the JAX package's exactly (levels, restore order) or within 1e-6.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch.vision import ops as TV
from torch_ops_parity import (compare, jax_jit_grads_many,  # noqa: F401
                              on_the_cpu, r)

TOL = 1e-5
F32 = np.float32


def _boxes(seed, n, side=64.0, lo=4.0, hi=24.0):
    """n xyxy boxes inside [0, side]^2 with sides in [lo, hi)."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(lo, hi, (n, 2))
    xy = rng.uniform(0, side - hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(F32)


def _unique_scores(seed, *shape):
    """Scores in (0, 1) with no two equal."""
    n = int(np.prod(shape))
    perm = np.random.RandomState(seed).permutation(n)
    return ((perm + 0.5) / n).reshape(shape).astype(F32)


FEAT = r(0, 2, 3, 8, 8)
ROIS = np.array([[1.0, 2.0, 9.0, 13.0], [0.0, 0.0, 15.0, 15.0],
                 [4.5, 3.0, 7.5, 11.0], [2.0, 6.0, 14.0, 9.0]], F32)
ROIS_NUM = np.array([3, 1], np.int32)
IMG = np.array([[64, 48], [32, 64]], np.int32)
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
# gt boxes (cx, cy, w, h): image 0's first gt sits at cell (0, 0) on
# anchor 0 of mask [0, 1, 2], the index every padded gt (w = h = 0)
# scatters to; image 1 has a gt on another scale's anchor
GT = np.array([[[0.05, 0.05, 10 / 64, 13 / 64], [0.6, 0.4, 0.3, 0.45],
                [0.0, 0.0, 0.0, 0.0], [0.3, 0.8, 0.2, 0.1]],
               [[0.5, 0.5, 0.9, 0.95], [0.2, 0.7, 0.25, 0.4],
                [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]], F32)
GT_LABEL = np.array([[1, 2, 0, 0], [0, 2, 0, 0]], np.int32)
PRIOR = _boxes(1, 6)
PRIOR_VAR = r(2, 6, 4, lo=0.1, hi=0.3)

CASES = {
    "box_iou": ((_boxes(3, 5), _boxes(4, 3)), {}),
    "roi_align": ((FEAT, ROIS, ROIS_NUM, 2), {"spatial_scale": 0.5}),
    "roi_align#sampling": ((FEAT, ROIS, ROIS_NUM, (3, 2)),
                           {"spatial_scale": 0.5, "sampling_ratio": 3,
                            "aligned": False}),
    "roi_pool": ((FEAT, ROIS, ROIS_NUM, 2), {"spatial_scale": 0.5}),
    "yolo_box": ((r(5, 2, 3 * 9, 4, 4), IMG, ANCHORS[:6], 4),
                 {"conf_thresh": 0.3, "downsample_ratio": 16}),
    "yolo_box#noclip": ((r(5, 2, 3 * 9, 4, 4), IMG, ANCHORS[:6], 4),
                        {"conf_thresh": 0.3, "downsample_ratio": 16,
                         "clip_bbox": False, "scale_x_y": 1.05}),
    "box_coder#decode": ((PRIOR, PRIOR_VAR, r(6, 3, 6, 4)),
                         {"code_type": "decode_center_size"}),
    "box_coder#encode": ((PRIOR, PRIOR_VAR, _boxes(7, 6)), {}),
}


def _float_pos(inputs):
    return [i for i, a in enumerate(inputs) if isinstance(a, np.ndarray)
            and a.dtype == F32]


def _fn(mod, name, kw):
    op = getattr(mod, name.split("#")[0])
    return lambda *a: op(*a, **kw)


@functools.lru_cache(maxsize=None)
def _jax():
    return jax_jit_grads_many({
        name: (_fn(JV, name, kw), list(args), _float_pos(args), None, 1)
        for name, (args, kw) in CASES.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_op_and_gradients_match_jax(name):
    args, kw = CASES[name]
    ts = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
          for a in args]
    pos = _float_pos(args)
    for i in pos:
        ts[i].requires_grad_()
    got = _fn(TV, name, kw)(*ts)
    first = got[0] if isinstance(got, tuple) else got
    w = np.random.RandomState(1).standard_normal(
        tuple(first.shape)).astype(F32)
    (first * torch.from_numpy(w)).sum().backward()
    want, jgrads, _ = _jax()[name]
    compare(name, got, want, TOL)
    assert len(jgrads) == len(pos)
    for i, jg in zip(pos, jgrads):
        g = ts[i].grad if ts[i].grad is not None else torch.zeros_like(ts[i])
        compare(f"{name} grad {i}", g, jg, TOL)


def test_yolov3_assignment_is_an_or_over_colliding_gts():
    """Image 0's real gt and its two padded gts write the same cell; the
    cell stays assigned, so its objectness is not also pulled to 0: the
    loss equals the loss with the padded gts taken out."""
    x = torch.from_numpy(r(8, 2, 3 * 8, 4, 4))
    args = (ANCHORS, [0, 1, 2], 3, 0.5, 16)
    full = TV.yolov3_loss(x, torch.from_numpy(GT),
                          torch.from_numpy(GT_LABEL), *args)
    real = TV.yolov3_loss(x[:1], torch.from_numpy(GT[:1, [0, 1, 3]]),
                          torch.from_numpy(GT_LABEL[:1, [0, 1, 3]]), *args)
    padded_last = TV.yolov3_loss(
        x[:1], torch.from_numpy(GT[:1, [2, 2, 0, 1, 3]]),
        torch.from_numpy(GT_LABEL[:1, [2, 2, 0, 1, 3]]), *args)
    np.testing.assert_allclose(full[0].item(), real[0].item(), rtol=1e-6)
    np.testing.assert_allclose(padded_last[0].item(), real[0].item(),
                               rtol=1e-6)


def _host(o):
    return o.numpy() if torch.is_tensor(o) else np.asarray(o._value)


def _nms_boxes(seed, n):
    """Boxes in clusters, so that NMS suppresses some of each."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(10, 54, (4, 2))
    c = centres[rng.randint(0, 4, n)] + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(6, 14, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(F32)


NMS_CASES = {
    "plain": dict(iou_threshold=0.4),
    "categories": dict(iou_threshold=0.5, top_k=12, cats=True),
    "pixels_eta": dict(iou_threshold=0.7, offset=1.0, eta=0.9, cats=True),
    "no_scores": dict(iou_threshold=0.3, no_scores=True),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_is_index_exact(case):
    kw = dict(NMS_CASES[case])
    b = _nms_boxes(11, 40)
    s = _unique_scores(12, 40)
    cat = np.random.RandomState(13).randint(0, 3, 40).astype(np.int32)
    jkw, tkw = {}, {}
    if not kw.pop("no_scores", False):
        jkw["scores"], tkw["scores"] = paddle.to_tensor(s), \
            torch.from_numpy(s)
    if kw.pop("cats", False):
        jkw["category_idxs"] = paddle.to_tensor(cat)
        tkw["category_idxs"] = torch.from_numpy(cat)
    want = JV.nms(paddle.to_tensor(b), **jkw, **kw)
    got = TV.nms(torch.from_numpy(b), **tkw, **kw)
    compare(case, got, want, 0)
    assert 0 < got.numel() < 40


MNMS_CASES = {
    "background_0": dict(score_threshold=0.3, nms_top_k=15, keep_top_k=20,
                         nms_threshold=0.4),
    "no_background": dict(score_threshold=0.2, nms_top_k=1000,
                          keep_top_k=100, nms_threshold=0.45,
                          background_label=-1),
    "pixels_eta": dict(score_threshold=0.1, nms_top_k=-1, keep_top_k=-1,
                       nms_threshold=0.6, normalized=False, nms_eta=0.8),
}


@pytest.mark.parametrize("case", sorted(MNMS_CASES))
def test_multiclass_nms_is_index_exact(case):
    b = np.stack([_nms_boxes(20, 40), _nms_boxes(21, 40)])
    s = _unique_scores(22, 2, 4, 40)
    s[1, 2] *= 0.1                         # a class with few candidates
    want = JV.multiclass_nms(paddle.to_tensor(b), paddle.to_tensor(s),
                             **MNMS_CASES[case])
    got = TV.multiclass_nms(torch.from_numpy(b), torch.from_numpy(s),
                            **MNMS_CASES[case])
    compare(case, got, want, TOL)
    # the labels and scores exactly: the rows are the same rows
    np.testing.assert_array_equal(_host(got[0])[:, :2],
                                  _host(want[0])[:, :2])
    assert _host(got[1]).sum() > 0


def test_multiclass_nms_of_nothing():
    b = np.stack([_nms_boxes(20, 8)])
    s = np.full((1, 3, 8), 0.01, F32)
    out, num = TV.multiclass_nms(torch.from_numpy(b), torch.from_numpy(s))
    assert tuple(out.shape) == (0, 6) and num.tolist() == [0]


def _rpn_inputs():
    A, H, W = 3, 4, 4
    anc, var = JV.anchor_generator(paddle.to_tensor(np.zeros(
        (1, 1, H, W), F32)), [16.0], [0.5, 1.0, 2.0], stride=[16.0, 16.0])
    sc = _unique_scores(30, 2, A, H, W)
    deltas = r(31, 2, 4 * A, H, W) * F32(0.5)
    img = np.array([[64, 64], [60, 50]], np.int32)
    return sc, deltas, img, _host(anc), _host(var)


@pytest.mark.parametrize("eta", [1.0, 0.8])
def test_generate_proposals_is_index_exact(eta):
    sc, deltas, img, anc, var = _rpn_inputs()
    kw = dict(pre_nms_top_n=30, post_nms_top_n=10, nms_thresh=0.6,
              min_size=2.0, eta=eta)
    want = JV.generate_proposals(paddle.to_tensor(sc),
                                 paddle.to_tensor(deltas),
                                 paddle.to_tensor(img),
                                 paddle.to_tensor(anc),
                                 paddle.to_tensor(var), **kw)
    got = TV.generate_proposals(*[torch.from_numpy(a) for a in
                                  (sc, deltas, img, anc, var)], **kw)
    compare("generate_proposals", got, want, TOL)
    np.testing.assert_array_equal(_host(got[1]), _host(want[1]))


def test_anchor_prior_and_fpn_levels_match_jax():
    feat = np.zeros((1, 2, 5, 6), F32)
    img = np.zeros((1, 3, 40, 48), F32)
    compare("anchor_generator",
            TV.anchor_generator(torch.from_numpy(feat), [32.0, 64.0],
                                [0.5, 1.0], offset=0.4),
            JV.anchor_generator(paddle.to_tensor(feat), [32.0, 64.0],
                                [0.5, 1.0], offset=0.4), 1e-6)
    kw = dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 24.0],
              aspect_ratios=[2.0, 3.0], clip=True)
    compare("prior_box",
            TV.prior_box(torch.from_numpy(feat), torch.from_numpy(img), **kw),
            JV.prior_box(paddle.to_tensor(feat), paddle.to_tensor(img), **kw),
            1e-6)
    rois = _boxes(40, 30, side=600.0, lo=8.0, hi=500.0)
    want = JV.distribute_fpn_proposals(paddle.to_tensor(rois), 2, 5, 4,
                                       224)
    got = TV.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4, 224)
    compare("distribute_fpn_proposals", got, want, 0)
    assert sum(1 for t in got[0] if t.numel()) >= 3
