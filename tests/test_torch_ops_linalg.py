"""paddle_tpu_torch.ops.linalg held to paddle_tpu.ops.linalg, op by op:
every name of the reference module's `__all__` on the same numpy inputs
through both packages, the outputs' types the JAX package's and the
values within 1e-4 x max(1, max |ref|) (float32 LAPACK / BLAS on both
sides, other algorithms and orders). A factorization unique only up to
signs is held on what is unique: `svd`'s singular values, the
reconstruction and the vectors up to sign; `qr` and `eigh` up to the
signs of their columns; `eig`'s sorted eigenvalues and A v = v diag(w).
`histogram` and `bincount` counts are exact."""
import numpy as np
import pytest
import torch

import paddle_tpu.ops.linalg as jl
import paddle_tpu_torch.ops.linalg as tl
from torch_ops_parity import (compare, host, jx, names_of,  # noqa: F401
                              on_the_cpu, r, ri, run_case, tx, type_name)

TOL = 1e-4
X = r(0, 4, 3)
Y = r(1, 3, 5)
SQ = r(2, 4, 4) + 4 * np.eye(4, dtype="float32")
SPD = (SQ @ SQ.T + np.eye(4, dtype="float32")).astype("float32")
B = r(3, 4, 2)
V3 = r(4, 5, 3)
TRI = np.triu(SQ)
TALL = r(5, 6, 3)

CASES = {
    "matmul": ((X, Y), {}),
    "matmul#transpose": ((X, r(6, 5, 3)), dict(transpose_y=True)),
    "mm": ((X, Y), {}),
    "bmm": ((r(7, 2, 3, 4), r(8, 2, 4, 2)), {}),
    "dot": ((X[:, 0], X[:, 1]), {}),
    "dot#rows": ((X, X * 2), {}),
    "mv": ((X, X[0]), {}),
    "norm": ((X,), {}),
    "norm#p_flat": ((X,), dict(p=3)),
    "norm#axis": ((X,), dict(p=2, axis=1, keepdim=True)),
    "norm#inf": ((X,), dict(p=float("inf"), axis=0)),
    "norm#ninf": ((X,), dict(p=float("-inf"), axis=1)),
    "norm#zero": ((X,), dict(p=0, axis=1)),
    "norm#matrix": ((r(9, 2, 3, 4),), dict(p="fro", axis=[1, 2])),
    "norm#nuc": ((SQ,), dict(p="nuc", axis=[0, 1])),
    "dist": ((X, X * 0.5), {}),
    "dist#p": ((X, X * 0.5), dict(p=1)),
    "dist#inf": ((X, X * 0.5), dict(p=float("inf"))),
    "dist#zero": ((X, X * 0.5), dict(p=0)),
    "cross": ((V3, r(10, 5, 3)), {}),
    "cross#axis": ((V3.T.copy(), r(10, 5, 3).T.copy()), dict(axis=0)),
    "cholesky": ((SPD,), {}),
    "cholesky#upper": ((SPD,), dict(upper=True)),
    "inverse": ((SQ,), {}),
    "det": ((SQ,), {}),
    "slogdet": ((SQ,), {}),
    "matrix_power": ((SQ * 0.3,), dict(n=3)),
    "matrix_power#neg": ((SQ,), dict(n=-2)),
    "svd": ((X,), {}),
    "qr": ((X,), {}),
    "qr#r": ((X,), dict(mode="r")),
    "eigh": ((SPD,), {}),
    "eigvalsh": ((SPD,), dict(UPLO="U")),
    "solve": ((SQ, B), {}),
    "triangular_solve": ((TRI, B), {}),
    "triangular_solve#lower_t": ((TRI.T.copy(), B),
                                 dict(upper=False, transpose=True)),
    "triangular_solve#unit": ((TRI, B), dict(unitriangular=True)),
    "pinv": ((X,), {}),
    "lstsq": ((TALL, r(11, 6, 2)), {}),
    "lstsq#vector": ((TALL, r(11, 6)), {}),
    "lstsq#rank_deficient": ((np.concatenate([TALL[:, :2], TALL[:, :1]], 1),
                              r(11, 6, 2)), {}),
    "einsum": (("ij,jk->ik", X, Y), {}),
    "multi_dot": (([X, Y, r(12, 5, 2)],), {}),
    "matrix_rank": ((X,), {}),
    "matrix_rank#deficient": ((np.outer(V3[:, 0], V3[:, 1]),), {}),
    "histogram": ((r(13, 50),), dict(bins=7)),
    "histogram#range": ((r(13, 50),), dict(bins=4, min=-1, max=1)),
    "bincount": ((ri(14, 20, hi=6),), {}),
    "bincount#weights": ((ri(14, 20, hi=6), r(15, 20)), dict(minlength=8)),
    "cov": ((r(16, 3, 8),), {}),
    "cov#cols": ((r(16, 8, 3),), dict(rowvar=False, ddof=False)),
    "corrcoef": ((r(17, 3, 8),), {}),
    "corrcoef#cols": ((r(17, 8, 3),), dict(rowvar=False)),
    "cdist": ((r(18, 4, 3), r(19, 5, 3)), {}),
    "cdist#p1": ((r(18, 4, 3), r(19, 5, 3)), dict(p=1.0)),
    "cdist#no_mm": ((r(18, 4, 3), r(19, 5, 3)),
                    dict(compute_mode="donot_use_mm_for_euclid_dist")),
    "cdist#inf": ((r(18, 2, 4, 3), r(19, 2, 5, 3)), dict(p=float("inf"))),
    "lu": ((SQ,), {}),
    "lu#infos": ((r(20, 2, 3, 3),), dict(get_infos=True)),
    "eig": ((SQ,), {}),
    "eigvals": ((SQ,), {}),
}
UP_TO_SIGN = {"svd", "qr", "eigh", "eig", "eigvals"}


def test_every_reference_name_has_a_case():
    assert names_of(jl) == sorted(tl.__all__)
    assert set(names_of(jl)) == {n.split("#")[0] for n in CASES} | {
        "lu_unpack"}


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n.split("#")[0] not in UP_TO_SIGN))
def test_op_matches_jax(name):
    run_case(jl, tl, name, CASES[name], TOL)


def _both(name):
    args, kw = CASES[name]
    fn = name.split("#")[0]
    return (getattr(tl, fn)(*[tx(a) for a in args], **kw),
            getattr(jl, fn)(*[jx(a) for a in args], **kw))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=TOL * max(1.0, np.abs(b).max()))


def _signs(m):
    """Each column's sign, by its entry of largest magnitude."""
    i = np.abs(m).argmax(0)
    return np.sign(m[i, np.arange(m.shape[1])])


def test_svd_up_to_signs():
    (u, s, vh), (ju, js_, jvh) = _both("svd")
    assert [type_name(t) for t in (u, s, vh)] == \
        [type_name(t) for t in (ju, js_, jvh)]
    u, s, vh = host(u), host(s), host(vh)
    ju, js_, jvh = host(ju), host(js_), host(jvh)
    _close(s, js_)
    _close((u * s) @ vh, X)
    _close(u * _signs(u), ju * _signs(ju))
    _close(vh.T * _signs(vh.T), jvh.T * _signs(jvh.T))


def test_qr_and_eigh_up_to_signs():
    (q, rr), (jq, jr) = _both("qr")
    q, rr, jq, jr = host(q), host(rr), host(jq), host(jr)
    _close(q @ rr, X)
    sq, sj = np.sign(np.diag(rr)), np.sign(np.diag(jr))
    _close(q * sq, jq * sj)
    _close(rr * sq[:, None], jr * sj[:, None])
    (w, v), (jw, jv) = _both("eigh")
    w, v, jw, jv = host(w), host(v), host(jw), host(jv)
    _close(w, jw)
    _close(v * _signs(v), jv * _signs(jv))


@pytest.mark.parametrize("name", ["eig", "eigvals"])
def test_eig_values_and_vectors(name):
    got, want = _both(name)
    w = host(got[0] if name == "eig" else got)
    jw = host(want[0] if name == "eig" else want)
    assert type_name(got[0] if name == "eig" else got) == "complex64"
    _close(np.sort_complex(w), np.sort_complex(jw))
    if name == "eig":
        v = host(got[1])
        _close(SQ @ v, v * w)


def test_lu_unpack_matches_jax():
    lu_t, piv_t = tl.lu(torch.from_numpy(SQ.copy()))
    lu_j, piv_j = jl.lu(jx(SQ))
    compare("lu_unpack", tl.lu_unpack(lu_t, piv_t), jl.lu_unpack(lu_j, piv_j),
            TOL)
    p, lo, up = (host(t) for t in tl.lu_unpack(lu_t, piv_t))
    _close(p @ lo @ up, SQ)
