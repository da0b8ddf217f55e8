"""paddle_tpu_torch.ops.legacy held to paddle_tpu.ops.legacy.

Every name the port's `legacy` defines (the 48 of the reference's
`legacy.__all__` that are not `extra_ops` re-exports) runs in both
packages on the same seeded numpy inputs, one parametrised test a family
with a case per name ("name" or "name#variant"): elementwise, reduce,
misc, selected_rows, arrays, lod (the LoDTensor and sequence ops, whose
offsets are compared too), params and print. The values within 1e-6 x
max(1, max |ref|), integers and bools exactly, the JAX package's types
(`torch_ops_parity.compare`). `test_every_name_has_a_case` keeps the
cases whole.

The static-mode pieces: `Print` records one op and is silent while a
Program is built (as the JAX package's), then prints at each run up to
`first_n`; a Program holding a `create_parameter` (an Assign
initializer in both packages) trains three SGD steps through
`Executor.run` to the JAX Program's losses (rtol 1e-5) and weights.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import static as jst
from paddle_tpu.framework.selected_rows import SelectedRows as JRows
from paddle_tpu.ops import legacy as JL
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.framework.selected_rows import SelectedRows as TRows
from paddle_tpu_torch.ops import legacy as TL
from torch_ops_parity import (compare, on_the_cpu, r,  # noqa: F401
                              ri)

TOL = 1e-6


class Pkg:
    """One package's side of a case: its legacy module, its tensor maker,
    its SelectedRows and its initializers."""

    def __init__(self, L, tensor, rows, init):
        self.L, self.t, self.Rows, self.init = L, tensor, rows, init


JAX = Pkg(JL, J.to_tensor, JRows, J.nn.initializer)
PORT = Pkg(TL, lambda a: torch.from_numpy(np.array(a)), TRows,
           T.nn.initializer)


def _lod(out):
    return out.lod() if hasattr(out, "lod") else None


def run(case):
    fn = CASES[case]
    want, got = fn(JAX), fn(PORT)
    compare(case, got, want, TOL)
    for w, g in zip(_flat(want), _flat(got)):
        assert _lod(g) == _lod(w), (case, _lod(g), _lod(w))


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [out]


X = r(1, 2, 3, 4)
Y = r(2, 2, 3, 4)
POS = r(3, 2, 3, 4, lo=0.5, hi=2.0)
NZ = r(4, 2, 3, 4, lo=1.0, hi=3.0)
MID = r(5, 3)
SEQ = r(6, 7, 3)            # 7 rows of width 3
OFFS = [[0, 2, 2, 7]]       # three sequences, one empty
IDS = ri(7, 9, 1, lo=1, hi=40)

CASES = {}


def case(name):
    def deco(fn):
        CASES[name] = fn
        return fn
    return deco


FAMILIES = {}


def family(fam, names):
    FAMILIES[fam] = sorted(names)


# -- elementwise ---------------------------------------------------------------------

for _op, _a, _b in (("add", X, Y), ("sub", X, Y), ("mul", X, Y),
                    ("div", X, NZ), ("floordiv", X, NZ), ("mod", X, NZ),
                    ("pow", POS, Y), ("max", X, Y), ("min", X, Y)):
    CASES[f"elementwise_{_op}"] = (
        lambda P, op=_op, a=_a, b=_b: getattr(P.L, f"elementwise_{op}")(
            P.t(a), P.t(b)))
CASES["elementwise_add#axis"] = lambda P: P.L.elementwise_add(
    P.t(X), P.t(MID), axis=1)
CASES["elementwise_mul#act"] = lambda P: P.L.elementwise_mul(
    P.t(X), P.t(Y), act="relu")
CASES["elementwise_floordiv#int"] = lambda P: P.L.elementwise_floordiv(
    P.t(ri(8, 2, 5, lo=-9, hi=9)), P.t(ri(9, 2, 5, lo=1, hi=4)))
family("elementwise", [k for k in CASES if k.startswith("elementwise")])

# -- reduce --------------------------------------------------------------------------

BOOL = r(10, 3, 4) > 0
for _op in ("sum", "mean", "max", "min", "prod"):
    CASES[f"reduce_{_op}"] = (
        lambda P, op=_op: getattr(P.L, f"reduce_{op}")(P.t(X), dim=1,
                                                       keep_dim=True))
for _op in ("all", "any"):
    CASES[f"reduce_{_op}"] = (
        lambda P, op=_op: getattr(P.L, f"reduce_{op}")(P.t(BOOL), dim=0))
CASES["reduce_sum#all"] = lambda P: P.L.reduce_sum(P.t(X))
family("reduce", [k for k in CASES if k.startswith("reduce")])

# -- misc ----------------------------------------------------------------------------

INF = X.copy()
INF[0, 1, 2] = np.inf
NAN = X.copy()
NAN[1, 0, 3] = np.nan
MISC = {
    "add_n": lambda P: P.L.add_n([P.t(X), P.t(Y), P.t(POS)]),
    "add_n#one": lambda P: P.L.add_n(P.t(X)),
    "broadcast_shape": lambda P: P.L.broadcast_shape([2, 1, 3], [4, 3]),
    "crop_tensor": lambda P: P.L.crop_tensor(P.t(X), shape=[1, 2, -1],
                                             offsets=[1, 0, 0]),
    "fill_constant": lambda P: P.L.fill_constant([2, 3], "float32", 1.5),
    "fill_constant#out": lambda P: P.L.fill_constant(
        [2, 2], "float32", -2.0, out=P.t(np.zeros((2, 2), np.float32))),
    "has_inf": lambda P: (P.L.has_inf(P.t(INF)), P.L.has_inf(P.t(X))),
    "has_nan": lambda P: (P.L.has_nan(P.t(NAN)), P.L.has_nan(P.t(X))),
    "rank": lambda P: P.L.rank(P.t(X)),
    "shape": lambda P: P.L.shape(P.t(X)),
    "reverse": lambda P: P.L.reverse(P.t(X), [0, 2]),
    "scatter_nd": lambda P: P.L.scatter_nd(
        P.t(np.array([[1], [2], [1]], np.int32)), P.t(r(11, 3, 4)), [5, 4]),
}
CASES.update(MISC)
family("misc", MISC)

# -- selected rows ----------------------------------------------------------------------

ROWS = np.array([3, 1, 3, 0], np.int64)
VALS = r(12, 4, 2)


def _merged(P):
    m = P.L.merge_selected_rows(P.Rows(ROWS, VALS, 6))
    return np.asarray(m.rows), np.asarray(m.value), m.height


SR = {
    "get_tensor_from_selected_rows": lambda P:
        P.L.get_tensor_from_selected_rows(P.Rows(ROWS, VALS, 6)),
    "get_tensor_from_selected_rows#dense": lambda P:
        P.L.get_tensor_from_selected_rows(P.t(X)),
    "merge_selected_rows": lambda P: list(_merged(P)),
}
CASES.update(SR)
family("selected_rows", SR)

# -- tensor arrays ---------------------------------------------------------------------


def _arrays(P):
    arr = P.L.create_array("float32", [P.t(X)])
    arr = P.L.array_write(P.t(Y), 2, arr)
    return arr


ARR = {
    "create_array": lambda P: [P.L.create_array("float32", [P.t(X)])[0],
                               len(P.L.create_array())],
    "array_write": lambda P: [v for v in _arrays(P) if v is not None]
    + [_arrays(P)[1] is None],
    "array_read": lambda P: P.L.array_read(_arrays(P), 2),
    "array_length": lambda P: P.L.array_length(_arrays(P)),
    "tensor_array_to_tensor": lambda P: P.L.tensor_array_to_tensor(
        [P.t(X), P.t(r(13, 2, 1, 4))], axis=1),
    "tensor_array_to_tensor#stack": lambda P: P.L.tensor_array_to_tensor(
        [P.t(X), P.t(Y)], axis=0, use_stack=True),
    "LoDTensorArray": lambda P: [isinstance(P.L.LoDTensorArray(), list),
                                 isinstance(P.L.create_array(),
                                            P.L.LoDTensorArray)],
}
CASES.update(ARR)
family("arrays", ARR)

# -- LoD ---------------------------------------------------------------------------------


def _seq(P, v=SEQ, offs=OFFS):
    return P.L.LoDTensor(v, offs)


LOD = {
    "LoDTensor": lambda P: [_seq(P), _seq(P).recursive_sequence_lengths(),
                            P.L.LoDTensor().shape[0]],
    "sequence_pad": lambda P: P.L.sequence_pad(_seq(P), pad_value=-1.0),
    "sequence_pad#maxlen": lambda P: P.L.sequence_pad(_seq(P), maxlen=6),
    "sequence_unpad": lambda P: P.L.sequence_unpad(
        P.t(r(14, 3, 4, 2)), P.t(np.array([2, 0, 3], np.int32))),
    "sequence_softmax": lambda P: P.L.sequence_softmax(
        _seq(P, r(15, 7, 1))),
    "sequence_reverse": lambda P: P.L.sequence_reverse(_seq(P)),
    "sequence_concat": lambda P: P.L.sequence_concat(
        [_seq(P), _seq(P, r(16, 4, 3), [[0, 1, 3, 4]])]),
    "sequence_expand": lambda P: P.L.sequence_expand(
        _seq(P, r(17, 3, 3), [[0, 1, 2, 3]]),
        _seq(P, r(18, 5, 1), [[0, 2, 2, 5]])),
    "sequence_expand#dense": lambda P: P.L.sequence_expand(
        P.t(r(19, 3, 2)), _seq(P, r(18, 5, 1), [[0, 2, 3, 5]])),
    "sequence_reshape": lambda P: P.L.sequence_reshape(
        _seq(P, r(20, 6, 2), [[0, 2, 6]]), 4),
    "sequence_slice": lambda P: P.L.sequence_slice(
        _seq(P), P.t(np.array([0, 0, 1], np.int32)),
        P.t(np.array([2, 0, 3], np.int32))),
    "sequence_scatter": lambda P: P.L.sequence_scatter(
        P.t(r(21, 3, 6)), _seq(P, np.array([[0], [2], [2], [5], [1]],
                                           np.int32), [[0, 3, 3, 5]]),
        _seq(P, r(22, 5, 1), [[0, 3, 3, 5]])),
    "lod_reset": lambda P: P.L.lod_reset(P.t(SEQ), target_lod=[0, 3, 7]),
    "lod_reset#y": lambda P: P.L.lod_reset(P.t(SEQ), _seq(P)),
}
for _p in ("sum", "average", "sqrt", "max", "min", "last", "first"):
    LOD[f"sequence_pool#{_p}"] = (
        lambda P, p=_p: P.L.sequence_pool(_seq(P), pool_type=p))
CASES.update(LOD)
family("lod", LOD)

# -- parameters, globals, print options ------------------------------------------------

W0 = r(23, 3, 5)
PARAMS = {
    "create_parameter": lambda P: P.L.create_parameter(
        [3, 5], "float32", default_initializer=P.init.Assign(W0)) * 1.0,
    "create_parameter#bias": lambda P: P.L.create_parameter(
        [4], "float32", is_bias=True) * 1.0,
    "create_parameter#xavier": lambda P: list(P.L.create_parameter(
        [64, 32], "float32").shape),
    "create_global_var": lambda P: [
        P.L.create_global_var([2, 3], 0.5, "float32", persistable=True),
        P.L.create_global_var([1], 2, "int32", persistable=True,
                              name="g").persistable],
}
CASES.update(PARAMS)
family("params", PARAMS)

# -- pyramid hash ------------------------------------------------------------------------

HASH_W = r(24, 300 + 8)


def _hash(P, name, **kw):
    ids = P.L.LoDTensor(IDS, [[0, 4, 9]])
    return getattr(P.L, name)(ids, num_emb=16, space_len=300,
                              pyramid_layer=3, rand_len=8,
                              weights=P.t(HASH_W), **kw)


HASH = {
    "search_pyramid_hash": lambda P: _hash(P, "search_pyramid_hash"),
    "pyramid_hash": lambda P: _hash(P, "pyramid_hash"),
}
CASES.update(HASH)
family("pyramid_hash", HASH)


# -- the tests ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FAMILIES["elementwise"])
def test_elementwise(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["reduce"])
def test_reduce(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["misc"])
def test_misc(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["selected_rows"])
def test_selected_rows(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["arrays"])
def test_arrays(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["lod"])
def test_lod(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["params"])
def test_params(case):
    run(case)


@pytest.mark.parametrize("case", FAMILIES["pyramid_hash"])
def test_pyramid_hash(case):
    run(case)


def test_pyramid_hash_gradient_and_hash():
    """The gather is differentiable: each weight's gradient of the sum of
    the embeddings counts the rows that read it; the XXH32 copies agree."""
    w = torch.from_numpy(HASH_W.copy()).requires_grad_()
    ids = TL.LoDTensor(IDS, [[0, 4, 9]])
    out = TL.search_pyramid_hash(ids, num_emb=16, space_len=300,
                                 pyramid_layer=3, rand_len=8, weights=w)
    out.sum().backward()
    # windows of 2 and 3 ids: 3 + 2 grams of the 4 ids, 4 + 3 of the 5
    assert out.lod() == [[0, 5, 12]]
    assert float(w.grad.sum()) == out.numel()
    rng = np.random.RandomState(25)
    for n in (0, 3, 15, 16, 33):
        data = rng.bytes(n)
        assert TL._xxh32(data, 7) == JL._xxh32(data, 7)


PRINT = {
    "Print": dict(message="t", summarize=3),
    "Print#all": dict(message="t", summarize=-1, first_n=2),
    "Print#quiet": dict(message="t", print_tensor_shape=False,
                        print_tensor_type=False),
}


@pytest.mark.parametrize("case", sorted(PRINT))
def test_print(case):
    """The same lines, and the value passed through, in dygraph (each
    call is a Print of its own, so each prints once)."""
    lines = {}
    for name, P in (("jax", JAX), ("port", PORT)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for _ in range(3):
                out = P.L.Print(P.t(MID), **PRINT[case])
        lines[name] = buf.getvalue().splitlines()
        outs = lines.setdefault("out", [])
        outs.append(out)
    compare(case, lines["out"][1], lines["out"][0], TOL)
    assert lines["port"] == lines["jax"]
    assert len(lines["port"]) == 3


def test_set_printoptions():
    before = torch._tensor_str.PRINT_OPTS.precision
    try:
        TL.set_printoptions(precision=2, sci_mode=False)
        assert torch._tensor_str.PRINT_OPTS.precision == 2
        assert "0.12" in repr(torch.tensor([0.123456]))
    finally:
        torch.set_printoptions(precision=before, sci_mode=None)


def test_every_name_has_a_case():
    # extra_ops' names, which legacy re-exports, are held in
    # test_torch_extra_ops.py
    from paddle_tpu_torch.ops import extra_ops
    names = {n for n in TL.__all__ if n not in (
        "elementwise_add", "elementwise_sub", "elementwise_mul",
        "elementwise_div", "get_default_dtype", "set_default_dtype")
        and n not in extra_ops.__all__}
    assert len(names) == 48
    covered = {c.split("#")[0] for c in CASES} | {"Print",
                                                  "set_printoptions"}
    assert names <= covered, sorted(names - covered)
    assert set(TL.__all__) <= set(JL.__all__)


# -- static mode ----------------------------------------------------------------------------

XS = r(26, 4, 3)
TS = r(27, 4, 2)
W1 = r(28, 3, 2)


def _program(P, st, pkg, out):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [4, 3], "float32")
        t = st.data("t", [4, 2], "float32")
        w = P.L.create_parameter([3, 2], "float32",
                                 default_initializer=P.init.Assign(W1))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            y = P.L.Print(pkg.matmul(x, w), message="y", first_n=2,
                          summarize=3)
        out["build"] = buf.getvalue()
        loss = pkg.mean((y - t) ** 2)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _train(P, st, pkg, exe):
    out = {}
    pkg.enable_static()
    try:
        main, startup, loss = _program(P, st, pkg, out)
        exe = exe()
        exe.run(startup)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["losses"] = [float(np.asarray(exe.run(
                main, feed={"x": XS, "t": TS}, fetch_list=[loss])[0]))
                for _ in range(3)]
        out["run"] = buf.getvalue().splitlines()
        out["ops"] = [op.name for op in main.ops] if hasattr(
            main.ops[0], "name") else None
        (name,) = main.param_vars
        out["w"] = np.asarray(st.global_scope()[name])
    finally:
        pkg.disable_static()
    return out


def test_create_parameter_trains_and_print_in_a_program():
    jout = _train(JAX, jst, J, jst.Executor)
    tout = _train(PORT, tst, T, lambda: tst.Executor(T.CPUPlace()))
    # silent while the Program is built, in both packages
    assert jout["build"] == "" and tout["build"] == ""
    assert "print" in tout["ops"]
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-5)
    np.testing.assert_allclose(tout["w"], jout["w"], rtol=1e-5, atol=1e-6)
    assert tout["losses"][2] < tout["losses"][0]
    # the port replays the op eagerly: the values print at run time, up
    # to first_n
    assert len(tout["run"]) == 2
    assert all(line.startswith("y shape=(4, 2) dtype=float32 value=[")
               for line in tout["run"])
