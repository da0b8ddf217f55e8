"""Linear algebra ops (port of `paddle_tpu.ops.linalg`; reference
`python/paddle/tensor/linalg.py`).

`matmul`, `mm`, `bmm` and `einsum` are the white-listed products of
AMP: each casts its arguments through `amp.cast_args` under its op name,
as the JAX package's `apply_op` does, then promotes mixed floating types
to their common type as `jnp.matmul` does (a bfloat16 and a float32
operand give a float32 product; torch's own products refuse mixed
types). The products go to torch's GEMMs, as the JAX package leaves them
to XLA.

The rest (`cholesky`, `det`, `svd`, `solve`, `lstsq`, ...) are
`torch.linalg` (LAPACK on the CPU, cuSOLVER / cuBLAS on the card), cast
by their JAX names through AMP as well ("norm" is on the black list).
No TPU kernel lies under any of them. Results follow the JAX package's
conventions: `svd` gives (u, s, vh), `slogdet` one stacked [sign,
log|det|] tensor, `lu` 1-based int32 pivots, `matrix_rank` and
`histogram` int32, `lstsq` (solution, residuals, rank, singular values)
through an SVD as `jnp.linalg.lstsq` computes them. A factorization
is unique only up to signs (QR, SVD, eigenvectors), and cuSOLVER and
LAPACK may pick other ones."""
from __future__ import annotations

import functools

import torch

from .. import amp
from ._util import named
from ..framework.static_hook import named_op

__all__ = ["matmul", "mm", "bmm", "dot", "mv", "norm", "dist", "cross",
           "cholesky", "inverse", "det", "slogdet", "matrix_power", "svd",
           "qr", "eigh", "eigvalsh", "solve", "triangular_solve", "pinv",
           "lstsq", "einsum", "multi_dot", "matrix_rank", "histogram",
           "bincount", "cov", "corrcoef", "cdist", "lu", "lu_unpack", "eig",
           "eigvals"]


def promoted(*tensors):
    """`tensors` with every floating tensor cast to their common
    floating type (jnp's promotion: bfloat16 with float16 gives float32);
    other arguments as they are."""
    types = {t.dtype for t in tensors
             if torch.is_tensor(t) and t.is_floating_point()}
    if len(types) <= 1:
        return tensors
    dt = functools.reduce(torch.promote_types, types)
    return tuple(t.to(dt) if torch.is_tensor(t) and t.is_floating_point()
                 else t for t in tensors)


@named_op
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, each transposed over its last two axes first when asked
    (a 1-D operand is never transposed)."""
    a, b = promoted(*amp.cast_args("matmul", x, y))
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@named_op
def mm(input, mat2, name=None):
    return torch.matmul(*promoted(*amp.cast_args("mm", input, mat2)))


@named_op
def bmm(x, y, name=None):
    return torch.matmul(*promoted(*amp.cast_args("bmm", x, y)))


@named_op
def einsum(equation, *operands):
    return torch.einsum(equation,
                        *promoted(*amp.cast_args("einsum", *operands)))


@named_op
def dot(x, y, name=None):
    """Inner product of 1-D vectors, or of each row of 2-D ones."""
    a, b = named("dot", x, y)
    if a.dim() == 1:
        return torch.dot(a, b)
    return torch.sum(a * b, dim=-1)


@named_op
def mv(x, vec, name=None):
    a, b = named("mv", x, vec)
    return torch.matmul(a, b)


def _inf(p):
    return p == float("inf")


@named_op
def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The Frobenius norm of every entry ("fro", axis None; keepdim
    ignored, as in the JAX package); the p-norm of the flattened tensor
    (axis None); a matrix norm over two axes or a vector norm over one
    given as a list; a p-norm along an int axis (inf: max |x|, -inf:
    min |x|, 0: the count of non-zeros)."""
    (v,) = named("norm", x)
    if p == "fro" and axis is None:
        return torch.sqrt(torch.sum(v * v))
    if axis is None:
        return torch.linalg.vector_norm(v.reshape(-1), ord=p)
    if isinstance(axis, (list, tuple)):
        if len(axis) == 2:
            return torch.linalg.matrix_norm(v, ord=p, dim=tuple(axis),
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(v, ord=2 if p == "fro" else p,
                                        dim=tuple(axis), keepdim=keepdim)
    if _inf(p):
        return torch.amax(v.abs(), axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(v.abs(), axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((v != 0).to(v.dtype), axis, keepdim=keepdim)
    p = 2 if p == "fro" else p
    return torch.sum(v.abs() ** p, axis, keepdim=keepdim) ** (1.0 / p)


@named_op
def dist(x, y, p=2, name=None):
    """The p-norm of x - y over every entry."""
    a, b = named("dist", x, y)
    d = a - b
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    if _inf(p):
        return torch.amax(d.abs())
    if p == float("-inf"):
        return torch.amin(d.abs())
    return torch.sum(d.abs() ** p) ** (1.0 / p)


@named_op
def cross(x, y, axis=9, name=None):
    """The cross product along `axis`; 9 (the default) picks the first
    axis of size 3."""
    a, b = named("cross", x, y)
    if axis == 9:
        axis = next(i for i, s in enumerate(a.shape) if s == 3)
    return torch.linalg.cross(a, b, dim=axis)


@named_op
def cholesky(x, upper=False, name=None):
    (v,) = named("cholesky", x)
    return torch.linalg.cholesky(v, upper=upper)


@named_op
def inverse(x, name=None):
    (v,) = named("inverse", x)
    return torch.linalg.inv(v)


@named_op
def det(x, name=None):
    (v,) = named("det", x)
    return torch.linalg.det(v)


@named_op
def slogdet(x, name=None):
    """[sign, log|det|] stacked on a new leading axis."""
    (v,) = named("slogdet", x)
    sign, logdet = torch.linalg.slogdet(v)
    return torch.stack([sign, logdet])


@named_op
def matrix_power(x, n, name=None):
    (v,) = named("matrix_power", x)
    return torch.linalg.matrix_power(v, n)


@named_op
def svd(x, full_matrices=False, name=None):
    """(u, s, vh) with x = u diag(s) vh."""
    (v,) = named("svd", x)
    return tuple(torch.linalg.svd(v, full_matrices=full_matrices))


@named_op
def qr(x, mode="reduced", name=None):
    """(q, r); `mode="r"` gives r alone."""
    (v,) = named("qr", x)
    q, r = torch.linalg.qr(v, mode=mode)
    return r if mode == "r" else (q, r)


@named_op
def eigh(x, UPLO="L", name=None):
    (v,) = named("eigh", x)
    return tuple(torch.linalg.eigh(v, UPLO=UPLO))


@named_op
def eigvalsh(x, UPLO="L", name=None):
    (v,) = named("eigvalsh", x)
    return torch.linalg.eigvalsh(v, UPLO=UPLO)


@named_op
def solve(x, y, name=None):
    a, b = named("solve", x, y)
    return torch.linalg.solve(a, b)


@named_op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """X with op(x) X = y, op(x) = x or (`transpose`) its transpose."""
    a, b = named("triangular_solve", x, y)
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


@named_op
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    (v,) = named("pinv", x)
    return torch.linalg.pinv(v, rtol=rcond, hermitian=hermitian)


@named_op
def lstsq(x, y, rcond=None, driver=None, name=None):
    """The least-squares solution of x X = y through x's SVD, as
    `jnp.linalg.lstsq` computes it: singular values below rcond x the
    largest cut (rcond None: eps x max(m, n)); returns (X, the squared
    residual norms of y's columns, the rank, the singular values).
    `driver` is taken and unused."""
    a, b = named("lstsq", x, y)
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                        torch.zeros((), dtype=s.dtype, device=s.device))
    vec = b.dim() == 1
    bb = b.unsqueeze(-1) if vec else b
    sol = vh.mT @ (s_inv.unsqueeze(-1) * (u.mT @ bb))
    resid = torch.sum((bb - a @ sol) ** 2, dim=-2)
    rank = keep.sum(-1).to(torch.int32)
    return (sol.squeeze(-1) if vec else sol), resid, rank, s


@named_op
def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(named("multi_dot", *x)))


@named_op
def matrix_rank(x, tol=None, hermitian=False, name=None):
    (v,) = named("matrix_rank", x)
    return torch.linalg.matrix_rank(v, rtol=tol, hermitian=hermitian) \
        .to(torch.int32)


@named_op
def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts (int32) of `input`'s entries in `bins` equal bins over
    [min, max] (over [input.min(), input.max()] when both are 0); the
    last bin takes its right edge, entries outside are not counted."""
    (v,) = named("histogram", input)
    v = v.reshape(-1).float()
    if min != 0 or max != 0:
        lo = torch.tensor(float(min), device=v.device)
        hi = torch.tensor(float(max), device=v.device)
    else:
        lo, hi = v.min(), v.max()
    edges = lo + (hi - lo) * torch.linspace(0.0, 1.0, bins + 1,
                                            device=v.device)
    b = torch.searchsorted(edges, v, right=True) - 1
    b = torch.where(v == hi, torch.full_like(b, bins - 1), b)
    inside = (v >= lo) & (v <= hi)
    b = torch.where(inside, b, torch.full_like(b, bins))
    return torch.bincount(b, minlength=bins + 1)[:bins].to(torch.int32)


@named_op
def bincount(x, weights=None, minlength=0, name=None):
    """Counts of each non-negative int (int32), or the sums of `weights`
    at them (in the weights' type)."""
    if weights is None:
        (v,) = named("bincount", x)
        return torch.bincount(v.long(), minlength=minlength).to(torch.int32)
    v, w = named("bincount", x, weights)
    return torch.bincount(v.long(), w, minlength=minlength).to(w.dtype)


@named_op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Covariance of the variables (rows, or columns when not `rowvar`);
    `ddof` True divides by n - 1. The weights are taken and unused, as
    in the JAX package."""
    (v,) = named("cov", x)
    return torch.cov(v if rowvar or v.dim() < 2 else v.T,
                     correction=int(bool(ddof)))


@named_op
def corrcoef(x, rowvar=True, name=None):
    (v,) = named("corrcoef", x)
    return torch.corrcoef(v if rowvar or v.dim() < 2 else v.T)


@named_op
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distances, x [..., P, M], y [..., R, M] ->
    [..., P, R]. p 2 takes the JAX package's product form,
    sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0) + 1e-24), unless `compute_mode`
    is "donot_use_mm_for_euclid_dist"."""
    a, b = named("cdist", x, y)
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        a2 = torch.sum(a * a, dim=-1)[..., :, None]
        b2 = torch.sum(b * b, dim=-1)[..., None, :]
        ab = torch.einsum("...pm,...rm->...pr", a, b)
        return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0) + 1e-24)
    d = a[..., :, None, :] - b[..., None, :, :]
    if p == 0.0:
        return torch.sum((d != 0).to(a.dtype), dim=-1)
    if _inf(p):
        return torch.amax(d.abs(), dim=-1)
    return torch.sum(d.abs() ** p, dim=-1) ** (1.0 / p)


@named_op
def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots[, infos]): the packed factors and 1-based int32
    pivots (LAPACK's getrf, as `jax.scipy.linalg.lu_factor` + 1)."""
    (v,) = named("lu", x)
    lu_mat, piv = torch.linalg.lu_factor(v)
    piv = piv.to(torch.int32)
    if get_infos:
        infos = torch.zeros(tuple(v.shape[:-2]) or (1,), dtype=torch.int32,
                            device=v.device)
        return lu_mat, piv, infos
    return lu_mat, piv


@named_op
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of `lu`'s results, x = P L U."""
    lu_mat, piv = named("lu_unpack", x, y)
    return tuple(torch.lu_unpack(lu_mat, piv.to(torch.int32)))


@named_op
def eig(x, name=None):
    """(eigenvalues, eigenvectors) of a general square matrix, complex."""
    (v,) = named("eig", x)
    return tuple(torch.linalg.eig(v))


def eigvals(x, name=None):
    return eig(x, name=name)[0]
