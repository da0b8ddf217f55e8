"""Sequence-parallel attention: ring attention and Ulysses all-to-all
(port of `paddle_tpu.parallel.ring_attention`).

The JAX package runs both inside `shard_map` over the 'sp' mesh axis; the
port runs one process a rank, so both take the rank's LOCAL shards
[B, H, S_loc, D] (the global sequence is sp * S_loc, laid out
contiguously by rank) and talk over the live mesh's `axis_name` group:

* `ring_attention`: each of sp steps attends the resident K/V block with
  online-softmax statistics, then K/V take one hop around the ring
  (`distributed.collective.ppermute`, i -> i + 1). The causal mask is by
  global position (rank * S_loc + i), -1e30 where masked. The last hop,
  whose result the JAX loop discards, is not taken.
* `ulysses_attention`: `all_to_all` re-shards [B, H, S_loc, D] ->
  [B, H/sp, S, D], attends the whole sequence a head group, and
  re-shards back; the output is cast to the input type before the second
  re-shard, as there (`:142-143`).

The arithmetic is the JAX package's (`_block_attend`, `:42-61`): products
of the input type with float32 results, softmax statistics and the
accumulator in float32, P cast to V's type before its product, K/V
rotating in their own type. A product of two bf16/fp16 values is exact in
float32, so the port multiplies float32 copies and sums in float32; for
float32 inputs `_dot_precision`'s HIGHEST is TF32 off. The block math is
plain torch: there is no kernel on this path, as there is none in the
reference, and the flash / splash kernels are never launched from it.

`shard_map_ring_attention` takes whole [B, H, S, D] tensors (the same on
every rank of the sp group), attends the rank's S/sp rows and gathers the
result; its gradient with respect to the whole tensors is whole on every
rank (the slice's backward gathers, the gather's backward slices).

`sequence_sharded(layer)` marks a forward whose activations are sequence
shards (the sp train step): `F.scaled_dot_product_attention` refuses to
run under it, naming the layer, since it would attend within the shard
only.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Optional

import torch

from ..distributed.collective import all_to_all, ppermute
from ..framework.errors import InvalidArgumentError
from .mesh import get_mesh
from .spmd import _ShardGather, _ShardSlice

__all__ = ["ring_attention", "ulysses_attention", "shard_map_ring_attention",
           "sequence_sharded", "check_not_sequence_sharded"]

_NEG = -1e30


@contextlib.contextmanager
def _no_tf32():
    """float32 products at full precision (`Precision.HIGHEST`)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dot(a, b):
    """a @ b with float32 results: a 16-bit product is exact in float32,
    so float32 copies multiplied in float32 give the reference's
    `preferred_element_type=float32` product."""
    with _no_tf32():
        return torch.matmul(a.float(), b.float())


def _block_attend(q, k, v, scale, mask=None):
    """(max, sumexp, acc) of one K/V block; q [B,H,Sq,D], k/v [B,H,Sk,D]."""
    s = _dot(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG, device=s.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = _dot(p.to(v.dtype), v)
    return m, l, acc


def _axis(axis_name):
    """(size, this rank's coordinate) of the live mesh's sp axis."""
    mesh = get_mesh()
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return 1, 0
    return mesh.axis_size(axis_name), mesh.axis_rank(axis_name)


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None):
    """Blockwise ring attention over the rank's shards [B, H, S_loc, D]
    (see the module docstring); returns the rank's [B, H, S_loc, D] in
    q's type."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sp, my = _axis(axis_name)
    S = q.shape[2]
    ar = torch.arange(S, device=q.device)
    q_pos = my * S + ar
    m = torch.full(q.shape[:-1] + (1,), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    k_cur, v_cur = k, v
    for i in range(sp):
        kv_rank = (my - i) % sp
        mask = (q_pos[:, None] >= (kv_rank * S + ar)[None, :])[None, None] \
            if causal else None
        bm, bl, bacc = _block_attend(q, k_cur, v_cur, scale, mask)
        m_new = torch.maximum(m, bm)
        s_old = torch.exp(m - m_new)
        s_blk = torch.exp(bm - m_new)
        l = l * s_old + bl * s_blk
        acc = acc * s_old + bacc * s_blk
        m = m_new
        if i < sp - 1:
            k_cur = ppermute(k_cur, perm, axis_name)
            v_cur = ppermute(v_cur, perm, axis_name)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None):
    """All-to-all sequence parallelism over the rank's shards
    [B, H, S_loc, D], H % sp == 0 (see the module docstring)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sp, _ = _axis(axis_name)
    if q.shape[1] % sp:
        raise InvalidArgumentError(
            f"ulysses_attention: {q.shape[1]} heads do not split over "
            f"sp={sp}")
    qs, ks, vs = (all_to_all(t, 1, 2, axis_name) for t in (q, k, v))
    s = _dot(qs, ks.transpose(-1, -2)) * scale
    if causal:
        S = s.shape[-1]
        mask = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full((), _NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = _dot(p.to(vs.dtype), vs)
    return all_to_all(out.to(q.dtype), 2, 1, axis_name)


def shard_map_ring_attention(q, k, v, mesh=None, causal=False, impl="ring"):
    """Ring (or Ulysses, `impl="ulysses"`) attention of whole [B, H, S, D]
    tensors over the mesh's 'sp' axis: each rank attends its S/sp rows and
    the result is gathered; differentiable with whole gradients."""
    mesh = mesh or get_mesh()
    attn = ring_attention if impl == "ring" else ulysses_attention
    sp = mesh.axis_size("sp") if mesh is not None else 1
    if sp == 1:
        return attn(q, k, v, causal=causal)
    r, pg = mesh.axis_rank("sp"), mesh.group("sp")
    if q.shape[2] % sp:
        raise InvalidArgumentError(
            f"shard_map_ring_attention: sequence {q.shape[2]} does not "
            f"split over sp={sp}")
    loc = [_ShardSlice.apply(t, 2, r, sp, pg) for t in (q, k, v)]
    out = attn(*loc, causal=causal)
    return _ShardGather.apply(out, 2, r, sp, pg)


class _Seq(threading.local):
    def __init__(self):
        self.names = None


_seq = _Seq()


@contextlib.contextmanager
def sequence_sharded(layer=None):
    """Mark a forward over sequence shards (see the module docstring);
    `layer`'s module names name the one that calls whole-sequence
    attention. Nothing runs per module: the name is looked up on the call
    stack only when the error is raised."""
    names = ({id(m): (n or type(m).__name__)
              for n, m in layer.named_modules()} if layer is not None
             else {})
    prev, _seq.names = _seq.names, names
    try:
        yield
    finally:
        _seq.names = prev


def _calling_layer(names):
    """The name of the innermost module of `names` whose method is on
    the call stack."""
    f = sys._getframe(2)
    while f is not None:
        m = f.f_locals.get("self")
        if m is not None and id(m) in names:
            return names[id(m)]
        f = f.f_back
    return "<the model>"


def check_not_sequence_sharded(op="scaled_dot_product_attention"):
    """Raise InvalidArgumentError, naming the calling layer, when a
    whole-sequence attention runs on a sequence shard."""
    names = _seq.names
    if names is None:
        return
    where = _calling_layer(names)
    raise InvalidArgumentError(
        f"sequence-parallel step (sp_axis): layer '{where}' calls {op} on "
        f"its rank's sequence shard, which would attend within the shard "
        f"only; use ring or Ulysses attention there (GPT: "
        f"forward(..., use_ring=True))")
