"""nn's losses: every functional of `nn.functional.loss`'s `__all__` this
slice adds, and the 12 loss layers over them, held to paddle_tpu on the
same numpy inputs: values within 1e-5 x max(1, |ref|) and the gradient
of each float input (the JAX side of every case under one shared
`jax.jit`). The loss layers are also their functionals and keep the JAX
layers' defaults. `ctc_loss` runs the JAX package's recursion over
all T frames: it does not read `input_lengths` (ROADMAP C21), so it is
not `torch.nn.functional.ctc_loss`."""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_ops_parity import (compare, jax_jit_grads_many,  # noqa: F401
                              on_the_cpu, r, ri)

JF = paddle.nn.functional
TF = ptt.nn.functional
TOL = 1e-5

LOGP = np.log(np.random.RandomState(0).dirichlet(np.ones(5), 6)).astype(
    np.float32)
PROB = r(1, 6, 5, lo=0.05, hi=0.95)
Y01 = (r(2, 6, 5, lo=0, hi=1) > 0.5).astype(np.float32)
PM1 = np.where(r(3, 6) > 0, 1.0, -1.0).astype(np.float32)
CTC_LP = np.log(np.random.RandomState(4).dirichlet(np.ones(5), (7, 3))
                ).astype(np.float32)                 # [T 7, B 3, C 5]
CTC_LAB = np.array([[1, 2, 2], [3, 1, 0], [4, 4, 4]], np.int32)
CTC_IL = np.array([7, 5, 6], np.int32)
CTC_LL = np.array([3, 2, 1], np.int32)

CASES = {
    "softmax_with_cross_entropy": ((r(5, 6, 5), ri(6, 6, 1, hi=5)), {}),
    "softmax_with_cross_entropy#soft": (
        (r(5, 6, 5), PROB / PROB.sum(1, keepdims=True)),
        {"soft_label": True, "return_softmax": True}),
    "mse_loss": ((r(7, 6, 5), r(8, 6, 5)), {}),
    "mse_loss#sum": ((r(7, 6, 5), r(8, 6, 5)), {"reduction": "sum"}),
    "l1_loss": ((r(7, 6, 5), r(8, 6, 5)), {"reduction": "none"}),
    "nll_loss": ((LOGP, np.array([0, 4, 2, -100, 1, 3], np.int32)), {}),
    "nll_loss#weight": ((LOGP, ri(9, 6, hi=5), r(10, 5, lo=0.5, hi=2.0)),
                        {"reduction": "sum"}),
    "kl_div": ((LOGP, PROB), {}),
    "kl_div#batchmean": ((LOGP, PROB), {"reduction": "batchmean"}),
    "smooth_l1_loss": ((r(7, 6, 5), r(8, 6, 5)), {"delta": 0.7}),
    "binary_cross_entropy": ((PROB, Y01), {}),
    "binary_cross_entropy#weight": ((PROB, Y01, r(11, 6, 5, lo=0, hi=1)),
                                    {"reduction": "none"}),
    "binary_cross_entropy_with_logits": ((r(12, 6, 5), Y01), {}),
    "binary_cross_entropy_with_logits#weights": (
        (r(12, 6, 5), Y01, r(13, 6, 5, lo=0, hi=1)),
        {"pos_weight": r(14, 5, lo=0.5, hi=2.0), "reduction": "sum"}),
    "margin_ranking_loss": ((r(15, 6), r(16, 6), PM1), {"margin": 0.3}),
    "hinge_embedding_loss": ((r(17, 6), PM1), {"margin": 0.5}),
    "cosine_embedding_loss": ((r(18, 6, 4), r(19, 6, 4), PM1),
                              {"margin": 0.1}),
    "triplet_margin_loss": ((r(20, 6, 4), r(21, 6, 4), r(22, 6, 4)), {}),
    "triplet_margin_loss#swap": ((r(20, 6, 4), r(21, 6, 4), r(22, 6, 4)),
                                 {"swap": True, "p": 1.5}),
    "log_loss": ((PROB, Y01), {}),
    "square_error_cost": ((r(7, 6, 5), r(8, 6, 5)), {}),
    "sigmoid_focal_loss": ((r(12, 6, 5), Y01), {}),
    "sigmoid_focal_loss#norm": ((r(12, 6, 5), Y01,
                                 np.array([3.0], np.float32)),
                                {"reduction": "mean", "gamma": 1.5}),
    "dice_loss": ((PROB / PROB.sum(1, keepdims=True), ri(23, 6, 1, hi=5)),
                  {}),
    "npair_loss": ((r(24, 6, 4), r(25, 6, 4), ri(26, 6, hi=3)), {}),
    "ctc_loss": ((CTC_LP, CTC_LAB, CTC_IL, CTC_LL), {}),
    "ctc_loss#none": ((CTC_LP, CTC_LAB, CTC_IL, CTC_LL),
                      {"reduction": "none", "blank": 0}),
    "ctc_loss#short_inputs": ((CTC_LP, CTC_LAB, np.full(3, 2, np.int32),
                               CTC_LL), {"reduction": "none", "blank": 0}),
}


def test_every_added_loss_has_a_case():
    covered = {n.split("#")[0] for n in CASES}
    assert sorted(covered | {"cross_entropy"}) == sorted(TF.loss.__all__)
    assert sorted(covered | {"cross_entropy"}) == sorted(
        JF.loss.__all__)


def _float_pos(args):
    return [i for i, a in enumerate(args) if a.dtype == np.float32]


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's value and input gradients of every functional
    case and every layer case, under one `jax.jit`."""
    def functional(fn, kw):
        kw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        return lambda *a: getattr(JF, fn)(*a, **kw)
    cases = {name: (functional(name.split("#")[0], kw), args,
                    _float_pos(args), None, 1)
             for name, (args, kw) in CASES.items()}
    for name, kw, args in LAYERS:
        layer = getattr(paddle.nn, name)(**kw)
        cases[name] = (layer, args, _float_pos(args), layer, 1)
    return jax_jit_grads_many(cases)


def _port(name, fn, args):
    """The port's value of fn on `args` and the gradients of sum(first
    output * w), w as `jax_jit_grads_many` draws it from seed 1."""
    ts = [torch.from_numpy(a.copy()) for a in args]
    grad_pos = _float_pos(args)
    for i in grad_pos:
        ts[i].requires_grad_()
    got = fn(*ts)
    first = got[0] if isinstance(got, tuple) else got
    w = np.random.RandomState(1).standard_normal(
        tuple(first.shape)).astype(np.float32)
    (first * torch.from_numpy(w)).sum().backward()
    # an input with no path to the loss (a +-1 label read by a
    # comparison) has a zero gradient in the JAX package
    return got, [ts[i].grad if ts[i].grad is not None else
                 torch.zeros_like(ts[i]) for i in grad_pos]


def _compare_with_jax(name, got, grads):
    want, jgrads, _ = _jax()[name]
    compare(name, got, want, TOL)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        compare(name + " grad", g, jg, TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_jax(name):
    args, kw = CASES[name]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    fn = getattr(TF, name.split("#")[0])
    _compare_with_jax(name, *_port(name, lambda *a: fn(*a, **tkw), args))


def test_ctc_loss_ignores_input_lengths():
    """Input lengths of 2 give the losses of the full lengths, in both
    packages."""
    np.testing.assert_array_equal(
        np.asarray(_jax()["ctc_loss#short_inputs"][0]),
        np.asarray(_jax()["ctc_loss#none"][0]))
    args = [torch.from_numpy(a) for a in (CTC_LP, CTC_LAB, CTC_IL, CTC_LL)]
    a = TF.ctc_loss(*args, reduction="none")
    b = TF.ctc_loss(args[0], args[1], torch.tensor([2, 2, 2]), args[3],
                    reduction="none")
    assert torch.equal(a, b)
    # torch's CTC reads them: frames past each input length do not count
    lib = torch.nn.functional.ctc_loss(args[0], args[1].long(),
                                       args[2].long(), args[3].long(),
                                       reduction="none")
    assert float((lib - a).abs().max()) > 0.1


LAYERS = [
    ("MSELoss", {}, (r(7, 6, 5), r(8, 6, 5))),
    ("L1Loss", {"reduction": "sum"}, (r(7, 6, 5), r(8, 6, 5))),
    ("NLLLoss", {"ignore_index": 2}, (LOGP, ri(9, 6, hi=5))),
    ("KLDivLoss", {"reduction": "sum"}, (LOGP, PROB)),
    ("SmoothL1Loss", {"delta": 2.0}, (r(7, 6, 5), r(8, 6, 5))),
    ("BCELoss", {}, (PROB, Y01)),
    ("BCEWithLogitsLoss", {}, (r(12, 6, 5), Y01)),
    ("MarginRankingLoss", {"margin": 0.2}, (r(15, 6), r(16, 6), PM1)),
    ("HingeEmbeddingLoss", {}, (r(17, 6), PM1)),
    ("CosineEmbeddingLoss", {}, (r(18, 6, 4), r(19, 6, 4), PM1)),
    ("TripletMarginLoss", {"margin": 0.5}, (r(20, 6, 4), r(21, 6, 4),
                                            r(22, 6, 4))),
    ("CTCLoss", {"reduction": "sum"}, (CTC_LP, CTC_LAB, CTC_IL, CTC_LL)),
]


def test_every_loss_layer_has_a_case():
    assert sorted([n for n, _, _ in LAYERS] + ["CrossEntropyLoss"]) == \
        sorted(ptt.nn.layer.loss.__all__)


_LAYER_FN = {"MSELoss": "mse_loss", "L1Loss": "l1_loss",
             "NLLLoss": "nll_loss", "KLDivLoss": "kl_div",
             "SmoothL1Loss": "smooth_l1_loss",
             "BCELoss": "binary_cross_entropy",
             "BCEWithLogitsLoss": "binary_cross_entropy_with_logits",
             "MarginRankingLoss": "margin_ranking_loss",
             "HingeEmbeddingLoss": "hinge_embedding_loss",
             "CosineEmbeddingLoss": "cosine_embedding_loss",
             "TripletMarginLoss": "triplet_margin_loss",
             "CTCLoss": "ctc_loss"}


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: c[0])
def test_loss_layers_are_their_functionals(case):
    """Each layer matches the JAX package's layer built with the same
    arguments (value and input gradients), gives what its own functional
    gives with those arguments, and keeps the JAX layer's defaults."""
    name, kw, args = case
    layer = getattr(ptt.nn, name)(**kw)
    assert isinstance(layer, ptt.nn.Layer)
    _compare_with_jax(name, *_port(name, layer, args))
    ts = [torch.from_numpy(a.copy()) for a in args]
    fkw = {"margin": kw["margin"]} if name == "TripletMarginLoss" else kw
    torch.testing.assert_close(layer(*ts),
                               getattr(TF, _LAYER_FN[name])(*ts, **fkw),
                               rtol=0, atol=0)
    jl, tl = getattr(paddle.nn, name)(), getattr(ptt.nn, name)()
    for k, v in vars(jl).items():
        if not k.startswith("_") and k != "training":
            assert getattr(tl, k) == v, (name, k)
