"""GPT-style causal decoder (port of `paddle_tpu.models.gpt`).

The layer classes keep the JAX package's attribute names (`gpt.wte`,
`gpt.wpe`, `gpt.blocks.{i}.ln1`, `.attn.{q,k,v,out}_proj`, `.ln2`,
`.mlp.{0,2}`, or `.mlp.{gate,w_up,w_down}` in a mixture-of-experts
block, `gpt.ln_f`), so `load_reference_state` can copy a `paddle_tpu`
state dict across by name. `generate()` and the serving engine refuse a
mixture-of-experts GPT, as the JAX package's do.

Shared decode math (used by `generate()` and
`serving.GenerationEngine`): `gpt_prefill` runs the batched causal pass
and returns per-layer K/V for the caller's cache; `gpt_decode_step`
advances one position through caller-supplied `write_kv`/`attend` hooks.
Both consumers run these exact expressions, which is what keeps the
engine's greedy output token-identical to `generate()`.

The layers are the port's `nn` layers (`Linear`, `Embedding`,
`LayerNorm`, `GELU`, `Dropout`: torch.nn subclasses whose forwards go
through the port's named ops), and the LM head is
`ops.linalg.matmul(h, wte, transpose_y=True)`, so `amp.auto_cast` casts
the training forward where the JAX package's does. The decode math
below runs plain torch ops, outside every AMP hook, as the JAX package's
runs raw jnp outside `apply_op`: AMP never reaches serving.

Decode weights keep PyTorch's `[out, in]` Linear layout and go through
`F.linear`; the JAX package stores `[in, out]`. A projection that
`quantization.quantize_weights` replaced by a `WeightOnlyLinear`
contributes a `(q_int8 [out, in], scale [out])` leaf instead of a float
weight; `_gen_w` dequantizes it at its point of use, into a temporary of
the activations' type, so the integer tensor is the only copy that stays
on the device (the JAX package's `_gen_w`, `models/gpt.py:41-52`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from .. import amp
from ..framework.errors import InvalidArgumentError
from ..framework.place import resolve_device
from ..nn import initializer as I
from ..nn.functional import scaled_dot_product_attention
from ..nn.layer import GELU, Dropout, Embedding, LayerNorm, Linear
from ..ops.linalg import matmul, promoted
from ..ops.paged_ops import cached_attention
from ..parallel.mesh import P

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "MoEFeedForward",
           "gpt_prefill",
           "gpt_prefill_extend", "gpt_decode_step", "gpt_spec_verify",
           "gpt_logits", "dense_cache_write", "dense_cache_attend",
           "sample_logits", "sample_logits_with_noise", "sampling_noise",
           "load_reference_state", "decode_weight_specs",
           "shard_decode_weights"]


# -- shared decode math (generate() AND serving.GenerationEngine) -----------

def _gen_ln(x, w, b):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - m) / torch.sqrt(v + 1e-5) * w + b


def _gen_w(w, dtype):
    """Resolve one decode-weight leaf: a float tensor passes through; a
    weight-only-quantized leaf `(q_int8 [out, in], scale [out])` (from
    `decode_weights()` for a `quantization.WeightOnlyLinear`) is
    dequantized here, `q * scale` in `dtype`, a temporary of this product
    only."""
    if isinstance(w, tuple):
        q, s = w
        return q.to(dtype) * s.to(dtype)[:, None]
    return w


def _lin(x, w, b):
    """x W^T + b with W a decode-weight leaf (`_gen_w`)."""
    return TF.linear(x, _gen_w(w, x.dtype), b)


def gpt_logits(W, h):
    """Final LN + tied LM head over hidden states `h` [..., E]."""
    lnfw, lnfb = W["lnf"]
    return TF.linear(_gen_ln(h, lnfw, lnfb), W["wte"])


def _row_out(x, w, b, reduce):
    """A row-parallel projection: without `reduce` the plain `_lin`; with
    it (a tensor-parallel rank's input slice) the partial product reduced
    over the ranks, then the bias added once."""
    if reduce is None:
        return _lin(x, w, b)
    return reduce(_lin(x, w, None)) + b


def _gen_block_pass(W, h, attend, *, num_heads, reduce=None):
    """The batched transformer-block loop of a prefill: LN -> QKV heads
    -> `attend(layer, q, k, v)` -> output projection + MLP residuals,
    collecting per-layer K/V. Returns `(h, ks, vs)`, ks/vs
    [L, B, H, S, D]. On a tensor-parallel rank `W` holds its slice
    (`shard_decode_weights`), `num_heads` its local heads and `reduce`
    sums a row-parallel partial product over the ranks."""
    B, S = h.shape[:2]
    H = num_heads
    ks, vs = [], []
    for i, (l1w, l1b, wq, bq, wk, bk, wv, bv, wo, bo, l2w, l2b,
            w1, b1, w2, b2) in enumerate(W["blocks"]):
        x = _gen_ln(h, l1w, l1b)

        def heads(t):
            return t.reshape(B, S, H, -1).transpose(1, 2)
        q = heads(_lin(x, wq, bq))
        k = heads(_lin(x, wk, bk))
        v = heads(_lin(x, wv, bv))
        ks.append(k)
        vs.append(v)
        o = attend(i, q, k, v)
        o = o.transpose(1, 2).reshape(B, S, -1)
        h = h + _row_out(o, wo, bo, reduce)
        x2 = _gen_ln(h, l2w, l2b)
        h = h + _row_out(TF.gelu(_lin(x2, w1, b1)), w2, b2, reduce)
    return h, torch.stack(ks), torch.stack(vs)


def gpt_prefill(W, ids, *, num_heads, scale, reduce=None):
    """One batched causal pass over the whole prompt. Returns `(h, ks,
    vs)`: `h` [B,S,E] post-block pre-ln_f hidden states, `ks`/`vs`
    [L,B,H,S,D] per-layer K/V for the caller's cache. Attention goes
    through `F.scaled_dot_product_attention`, so an eligible CUDA shape
    takes the flash kernel; the plain path is the JAX package's masked
    softmax. Right-padded prompts are safe: causal masking keeps pad
    positions out of every real position's softmax."""
    S = ids.shape[1]
    h = W["wte"][ids] + W["wpe"][torch.arange(S, device=ids.device)][None]

    def attend(layer, q, k, v):
        return scaled_dot_product_attention(q, k, v, is_causal=True,
                                            training=False, scale=scale)

    return _gen_block_pass(W, h, attend, num_heads=num_heads,
                           reduce=reduce)


def gpt_prefill_extend(W, ids, positions, ctx_attend, *, num_heads,
                       scale, reduce=None):
    """Batched causal pass over a prompt TAIL whose prefix K/V already
    lives in an external cache (the prefix-cache hit path, and every
    prefill chunk).

    ids [B, S_t] tail token ids at absolute positions `positions` [S_t]
    (the caller clamps pad positions into range); attention is delegated
    per layer to

        ctx_attend(layer, q, k, v) -> [B, H, S_t, D]

    with q/k/v the tail's own projections: the hook attends each tail
    query over (cached context + the given within-tail K/V) and owns the
    cache layout, masks and softmax scale. Returns `(h, ks, vs)` like
    `gpt_prefill`; both run `_gen_block_pass`, so the block math cannot
    diverge from the full prefill."""
    del scale  # the ctx_attend hook owns the scale
    h = W["wte"][ids] + W["wpe"][positions][None]
    return _gen_block_pass(W, h, ctx_attend, num_heads=num_heads,
                           reduce=reduce)


def gpt_spec_verify(W, toks, positions, ctx_attend, *, num_heads,
                    reduce=None):
    """Batched multi-position decode block for speculative verification:
    score a [B, K+1] block of tokens (each row's current token followed
    by K draft tokens) at PER-ROW absolute positions [B, K+1] in one
    `_gen_block_pass`, so verifying K drafts costs one forward over K+1
    positions instead of K+1 decode steps. `ctx_attend(layer, q, k, v)
    -> [B, H, K+1, D]` is `gpt_prefill_extend`'s seam batched over rows.
    Returns `(h, ks, vs)` ([B, K+1, E] hidden states, [L, B, H, K+1, D]
    per-layer block K/V for the caller's acceptance-masked writes)."""
    h = W["wte"][toks] + W["wpe"][positions]
    return _gen_block_pass(W, h, ctx_attend, num_heads=num_heads,
                           reduce=reduce)


def gpt_decode_step(W, tok, pos, cache, write_kv, attend, *, num_heads,
                    scale, reduce=None):
    """Single-position forward against an abstract KV cache.

    tok [B] int; pos an int or [B] int tensor (THIS token's position —
    written before attending, so attention covers t <= pos):

        write_kv(cache, layer, k, v, pos) -> cache     (k/v [B, H, D])
        attend(cache, layer, q, pos)      -> [B, H, D]

    Returns (logits [B, V], cache)."""
    del scale  # the attend hook owns the scale
    B = tok.shape[0]
    H = num_heads
    h = W["wte"][tok] + W["wpe"][pos]
    for i, (l1w, l1b, wq, bq, wk, bk, wv, bv, wo, bo, l2w, l2b,
            w1, b1, w2, b2) in enumerate(W["blocks"]):
        x = _gen_ln(h, l1w, l1b)
        q = _lin(x, wq, bq).reshape(B, H, -1)
        k = _lin(x, wk, bk).reshape(B, H, -1)
        v = _lin(x, wv, bv).reshape(B, H, -1)
        cache = write_kv(cache, i, k, v, pos)
        o = attend(cache, i, q, pos).reshape(B, -1)
        h = h + _row_out(o, wo, bo, reduce)
        x2 = _gen_ln(h, l2w, l2b)
        h = h + _row_out(TF.gelu(_lin(x2, w1, b1)), w2, b2, reduce)
    return gpt_logits(W, h), cache


def decode_weight_specs(W, axis="tp"):
    """Partition specs matching a `decode_weights()` tree for head-sharded
    tensor parallelism over mesh axis `axis` (the JAX package's
    `decode_weight_specs`, Megatron's layout), in PyTorch's [out, in]
    layout: q/k/v/w1 column-parallel (output dim, the heads axis since
    E = H*D, split, with their biases), wo/w2 row-parallel (input dim
    split, biases replicated: added once after the all-reduce),
    embeddings and LNs replicated. A weight-only-quantized `(q [out, in],
    scale [out])` leaf splits its scale with the output dim it scales."""
    from ..parallel.mesh import P
    rep = P()

    def col(w):
        return ((P(axis, None), P(axis)) if isinstance(w, tuple)
                else P(axis, None))

    def row(w):
        return ((P(None, axis), rep) if isinstance(w, tuple)
                else P(None, axis))

    blocks = [
        (rep, rep, col(wq), P(axis), col(wk), P(axis), col(wv), P(axis),
         row(wo), rep, rep, rep, col(w1), P(axis), row(w2), rep)
        for (l1w, l1b, wq, bq, wk, bk, wv, bv, wo, bo, l2w, l2b,
             w1, b1, w2, b2) in W["blocks"]]
    return {"wte": rep, "wpe": rep, "lnf": (rep, rep), "blocks": blocks}


def shard_decode_weights(W, mesh, axis="tp"):
    """This rank's slice of a `decode_weights()` tree under
    `decode_weight_specs` on `mesh` (contiguous copies: the full tree can
    be dropped). A quantized `(q, scale)` leaf is a tuple, as `lnf` is,
    so the recursion walks the spec tree beside it."""
    from ..distributed.tensor_parallel import shard_tensor
    specs = decode_weight_specs(W, axis=axis)

    def put(w, s):
        if isinstance(w, tuple):
            return tuple(put(x, ss) for x, ss in zip(w, s))
        return shard_tensor(w, s, mesh).contiguous()

    return {
        "wte": put(W["wte"], specs["wte"]),
        "wpe": put(W["wpe"], specs["wpe"]),
        "lnf": tuple(put(w, s) for w, s in zip(W["lnf"], specs["lnf"])),
        "blocks": [tuple(put(w, s) for w, s in zip(blk, sblk))
                   for blk, sblk in zip(W["blocks"], specs["blocks"])],
    }


def dense_cache_write(cache, layer, k, v, pos):
    """Contiguous-buffer cache hook: cache = (kbufs, vbufs) [L,B,H,T,D],
    int `pos` (the whole batch decodes in lockstep — generate()'s
    layout). Writes in place."""
    kb, vb = cache
    kb[layer, :, :, pos] = k
    vb[layer, :, :, pos] = v
    return kb, vb


def dense_cache_attend(scale):
    """Attend hook over the contiguous cache: masked softmax over every
    position <= pos (`ops.paged_ops.cached_attention`, plain PyTorch)."""
    def attend(cache, layer, q, pos):
        kb, vb = cache
        return cached_attention(q, kb[layer], vb[layer], pos, scale)
    return attend


# -- layers ------------------------------------------------------------------

class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=1024, dropout=0.1,
                 use_moe=False, num_experts=8, moe_top_k=1,
                 initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.use_moe = use_moe
        self.num_experts = num_experts
        self.moe_top_k = moe_top_k
        self.initializer_range = initializer_range

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=128)
        d.update(kw)
        return cls(**d)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        E = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = E // cfg.num_heads
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(E, E, **kw)
        self.k_proj = Linear(E, E, **kw)
        self.v_proj = Linear(E, E, **kw)
        self.out_proj = Linear(E, E, **kw)
        self.dropout = cfg.dropout

    def forward(self, x, use_ring=False):
        """`use_ring`: causal ring attention over the live mesh's 'sp'
        axis (`parallel.ring_attention`, no dropout, no kernel), `x` being
        the rank's sequence shard; on a mesh without 'sp' the ring is one
        block, the whole sequence. AMP casts its inputs as the op
        "ring_attention" (in neither list)."""
        b, s, e = x.shape

        def shape(t):
            return t.reshape(b, s, self.num_heads, self.head_dim) \
                .transpose(1, 2)
        q, k, v = (shape(self.q_proj(x)), shape(self.k_proj(x)),
                   shape(self.v_proj(x)))
        if use_ring:
            from ..parallel.ring_attention import ring_attention
            q, k, v = amp.cast_args("ring_attention", q, k, v)
            out = ring_attention(q, k, v, causal=True)
        else:
            out = scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout,
                training=self.training)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, e))


class MoEFeedForward(nn.Module):
    """The mixture-of-experts feed-forward of `GPTConfig(use_moe=True)`
    (port of `paddle_tpu/models/gpt.py:366-405`): a top-1 switch gate and
    a dense one-hot dispatch, computed as the JAX package computes it:

        probs = softmax(gate(h));  e = argmax(probs)  (`top_k` is stored
        and ignored, as there);  onehot = one_hot(e) in h's type;
        g = sum(probs * onehot, -1)
        up = einsum("bse,bsd,edf->bsef", onehot, h, w_up)
        out = einsum("bsef,efd->bsd", gelu_tanh(up), w_down) * g

    Every token is multiplied by every expert (the one-hot zeroes the
    others), so the layer costs E times the routed products. GELU is the
    tanh approximation, `jax.nn.gelu`'s default (the `nn.GELU` layer's is
    exact). The layer is one op of AMP's, "moe_ffn", in neither list, so
    its arguments pass uncast; a bfloat16 `h` under O1 meets the float32
    experts and the products run in float32, as jnp promotes them
    (`ops.linalg.promoted`; ROADMAP C19). The products are plain einsums,
    outside any kernel, in both packages.

    Parameters: `gate` a `Linear(d, E)` with a bias, `w_up` [E, d, f] and
    `w_down` [E, f, d] (the JAX package's names and layouts; only the
    gate is transposed by `load_reference_state`), the experts drawn by
    `nn.initializer.XavierUniform` under the JAX package's fan rule.

    Expert parallel: built on a mesh whose "ep" axis has n > 1 ranks, a
    rank holds experts [r*E/n, (r+1)*E/n): `w_up` [E/n, d, f] and
    `w_down` [E/n, f, d], each marked ("ep", None, None) as the JAX
    package marks them (`:386-387`), cut from the full draw so a seeded
    run starts from one set of experts. The gate stays whole and routes
    over all E on every rank; the dispatch runs over the rank's experts
    (its one-hot columns), the hidden state entering them through
    `_CopyToParallel`, and their partial outputs are summed over "ep" by
    `_ReduceFromParallel`: the JAX package's einsums partitioned over e.
    """

    def __init__(self, hidden_size, intermediate_size, num_experts,
                 top_k=1, device=None, dtype=None):
        super().__init__()
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
        self.ep = mesh.axis_size("ep") if mesh is not None else 1
        self.ep_rank = mesh.axis_rank("ep") if self.ep > 1 else 0
        if num_experts % self.ep:
            raise InvalidArgumentError(
                f"{num_experts} experts do not split over ep={self.ep}")
        self.num_experts = num_experts
        self.top_k = top_k
        kw = dict(device=device, dtype=dtype)
        self.gate = Linear(hidden_size, num_experts, **kw)
        local = num_experts // self.ep
        self.w_up = nn.Parameter(torch.empty(
            local, hidden_size, intermediate_size, **kw))
        self.w_down = nn.Parameter(torch.empty(
            local, intermediate_size, hidden_size, **kw))
        if self.ep > 1:
            for p in (self.w_up, self.w_down):
                p.partition_spec = P("ep", None, None)
        self.reset_experts()

    @torch.no_grad()
    def reset_experts(self, generator=None):
        """Draw the full [E, ...] experts and keep this rank's block."""
        init = I.XavierUniform()
        for p in (self.w_up, self.w_down):
            full = torch.empty((self.num_experts,) + tuple(p.shape[1:]),
                               dtype=p.dtype, device=p.device)
            init(full, generator=generator)
            n = p.shape[0]
            p.copy_(full[self.ep_rank * n:(self.ep_rank + 1) * n])

    def forward(self, x):
        h, wu, wd, gw, gb = amp.cast_args(
            "moe_ffn", x, self.w_up, self.w_down, self.gate.weight,
            self.gate.bias)
        onehot_dtype = h.dtype
        h, wu, wd, gw, gb = promoted(h, wu, wd, gw, gb)
        probs = torch.softmax(TF.linear(h, gw, gb), dim=-1)
        onehot = TF.one_hot(torch.argmax(probs, dim=-1),
                            self.num_experts).to(onehot_dtype)
        gatev = torch.sum(probs * onehot, dim=-1, keepdim=True)
        onehot, h = promoted(onehot, h)
        group = None
        if self.ep > 1:
            from ..distributed.tensor_parallel import (_axis,
                                                       _CopyToParallel)
            group = _axis("ep")[0]
            n = wu.shape[0]
            onehot = onehot[..., self.ep_rank * n:(self.ep_rank + 1) * n]
            h = _CopyToParallel.apply(h, group)
        up = torch.einsum("bse,bsd,edf->bsef", onehot, h, wu)
        down = torch.einsum("bsef,efd->bsd",
                            TF.gelu(up, approximate="tanh"), wd)
        if group is not None:
            from ..distributed.tensor_parallel import _ReduceFromParallel
            down = _ReduceFromParallel.apply(down, group)
        return down * gatev


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(cfg.hidden_size, **kw)
        self.attn = CausalSelfAttention(cfg, **kw)
        self.ln2 = LayerNorm(cfg.hidden_size, **kw)
        if cfg.use_moe:
            self.mlp = MoEFeedForward(cfg.hidden_size,
                                      cfg.intermediate_size,
                                      cfg.num_experts, cfg.moe_top_k, **kw)
        else:
            self.mlp = nn.Sequential(
                Linear(cfg.hidden_size, cfg.intermediate_size, **kw),
                GELU(),
                Linear(cfg.intermediate_size, cfg.hidden_size, **kw))
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, use_ring=False):
        x = x + self.dropout(self.attn(self.ln1(x), use_ring=use_ring))
        x = x + self.dropout(self.mlp(self.ln2(x)))
        return x


def _positions(input_ids, use_ring):
    """[1, S] positions of `input_ids`' tokens: from 0, or, for a
    sequence shard under ring attention (`use_ring` on a mesh whose 'sp'
    axis is > 1), from sp_rank * S."""
    s = input_ids.shape[1]
    start = 0
    if use_ring:
        from ..parallel.mesh import axis_rank, axis_size
        if axis_size("sp") > 1:
            start = axis_rank("sp") * s
    return torch.arange(start, start + s, device=input_ids.device)[None]


class _GPTEmbeddingStage(nn.Module):
    """Pipeline pre-section: token + position embedding and the embedding
    dropout (the GPT's own modules; see `parallel.pipeline`)."""

    def __init__(self, gpt):
        super().__init__()
        self.wte = gpt.wte
        self.wpe = gpt.wpe
        self.drop = gpt.drop

    def forward(self, input_ids):
        return self.drop(self.wte(input_ids)
                         + self.wpe(_positions(input_ids, False)))


class _GPTHeadStage(nn.Module):
    """Pipeline post-section: the final LayerNorm, and with `lm` the tied
    LM head."""

    def __init__(self, gpt, lm):
        super().__init__()
        self.ln_f = gpt.ln_f
        self._lm = lm
        if lm:
            self.wte = gpt.wte

    def forward(self, h):
        h = self.ln_f(h)
        if not self._lm:
            return h
        return matmul(h, self.wte.weight, transpose_y=True)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig = None, device=None, dtype=None,
                 **kwargs):
        super().__init__()
        cfg = cfg or GPTConfig(**kwargs)
        self.config = cfg
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             **kw)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList([GPTBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, **kw)

    def forward(self, input_ids, use_ring=False):
        """`use_ring` (sequence parallel): every block attends through
        ring attention, and `input_ids` is the rank's sequence shard when
        the mesh's 'sp' axis is > 1 (positions start at sp_rank * S)."""
        h = self.drop(self.wte(input_ids)
                      + self.wpe(_positions(input_ids, use_ring)))
        for blk in self.blocks:
            h = blk(h, use_ring=use_ring)
        return self.ln_f(h)

    def pipeline_sections(self):
        """(pre, blocks, post) of `parallel.pipeline`: the embedding, the
        block list, the final LayerNorm."""
        return (_GPTEmbeddingStage(self), self.blocks,
                _GPTHeadStage(self, lm=False))


class GPTForCausalLM(nn.Module):
    """GPT with the tied LM head. Built on `device` (default the CUDA
    card; raises where there is none) with weights drawn from `seed`:
    normal(0, initializer_range) for embeddings and Linear weights, zero
    biases, unit LayerNorms."""

    def __init__(self, cfg: GPTConfig = None, device=None, dtype=None,
                 seed: int = 0, **kwargs):
        super().__init__()
        dev = resolve_device(device)
        self.gpt = GPTModel(cfg, device=dev, dtype=dtype, **kwargs)
        self._init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int):
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.gpt.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, MoEFeedForward):
                mod.reset_experts(generator=g)
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=g)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids, use_ring=False):
        return matmul(self.gpt(input_ids, use_ring=use_ring),
                      self.gpt.wte.weight, transpose_y=True)

    def pipeline_sections(self):
        """(pre, blocks, post) of `parallel.pipeline`: the embedding, the
        block list, the final LayerNorm with the tied LM head."""
        return (_GPTEmbeddingStage(self.gpt), self.gpt.blocks,
                _GPTHeadStage(self.gpt, lm=True))

    def decode_weights(self):
        """The decode-math weight dict shared by `generate()` and
        `serving.GenerationEngine` (detached parameter tensors, Linear
        weights in PyTorch's [out, in] layout). A projection replaced by
        `quantization.WeightOnlyLinear` contributes its
        `quant_decode_leaf()`, a `(q_int8, scale)` leaf (int4 unpacked
        once to int8), which `_gen_w` dequantizes at its point of use."""
        gpt = self.gpt
        if gpt.config.use_moe:
            raise NotImplementedError("generate() with MoE blocks")

        def lin(m):
            leaf = getattr(m, "quant_decode_leaf", None)
            w = leaf() if leaf is not None else m.weight.detach()
            return w, m.bias.detach()

        return {
            "wte": gpt.wte.weight.detach(), "wpe": gpt.wpe.weight.detach(),
            "lnf": (gpt.ln_f.weight.detach(), gpt.ln_f.bias.detach()),
            "blocks": [(
                blk.ln1.weight.detach(), blk.ln1.bias.detach(),
                *lin(blk.attn.q_proj), *lin(blk.attn.k_proj),
                *lin(blk.attn.v_proj), *lin(blk.attn.out_proj),
                blk.ln2.weight.detach(), blk.ln2.bias.detach(),
                *lin(blk.mlp[0]), *lin(blk.mlp[2]))
                for blk in gpt.blocks],
        }

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_k=None, temperature=1.0, seed=0):
        """Autoregressive decoding over a dense KV cache [L,B,H,T,D]: one
        batched prefill (`gpt_prefill`) writes the prompt's K/V, then a
        Python loop of `gpt_decode_step`s with plain masked attention
        (`dense_cache_attend`). Sampling draws from a `torch.Generator`
        seeded with `seed`. Returns [B, S + max_new_tokens] int64 on the
        model's device."""
        cfg = self.gpt.config
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(
            input_ids) else input_ids, device=dev).long()
        B, S = ids.shape
        T = S + int(max_new_tokens)
        if T > cfg.max_position_embeddings:
            raise ValueError(
                f"{T} positions exceed max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        W = self.decode_weights()
        L, H = cfg.num_layers, cfg.num_heads
        D = cfg.hidden_size // H
        scale = 1.0 / D ** 0.5
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kb = torch.zeros(L, B, H, T, D, dtype=W["wte"].dtype, device=dev)
        vb = torch.zeros_like(kb)
        h, ks, vs = gpt_prefill(W, ids, num_heads=H, scale=scale)
        kb[:, :, :, :S] = ks
        vb[:, :, :, :S] = vs
        logits = gpt_logits(W, h[:, -1])
        attend = dense_cache_attend(scale)
        toks = []
        for step in range(int(max_new_tokens)):
            tok = sample_logits(logits, do_sample, temperature, top_k, gen)
            toks.append(tok)
            logits, (kb, vb) = gpt_decode_step(
                W, tok, S + step, (kb, vb), dense_cache_write, attend,
                num_heads=H, scale=scale)
        return torch.cat([ids] + [t[:, None] for t in toks], dim=1)


def sample_logits(logits, do_sample, temperature, top_k, generator):
    """Greedy argmax (first max on ties), or a draw from the temperature-
    scaled, optionally top-k-truncated distribution using `generator`.
    logits [B, V] -> [B] int64."""
    if not do_sample:
        return torch.argmax(logits, -1)
    lg = logits.float() / max(float(temperature), 1e-6)
    if top_k:
        kth = torch.topk(lg, int(top_k), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full((), -1e30, device=lg.device),
                         lg)
    p = torch.softmax(lg, dim=-1)
    return torch.multinomial(p, 1, generator=generator)[:, 0]


def sampling_noise(shape, device, generator):
    """The Exp(1) draw that `torch.multinomial` makes for one sample a
    row of [B, V] probabilities, from `generator`: `sample_logits`' draw,
    taken apart so that a program can take it as an input."""
    return torch.empty(shape, dtype=torch.float32,
                       device=device).exponential_(1, generator=generator)


def sample_logits_with_noise(logits, temperature, top_k, noise):
    """`sample_logits(logits, True, temperature, top_k, g)` with its draw
    given as `noise = sampling_noise(logits.shape, device, g)`.
    `torch.multinomial`'s one-sample path is argmax(p / q) over q ~ Exp(1)
    filled by `exponential_`, so both give the same token from the same
    generator state."""
    lg = logits.float() / max(float(temperature), 1e-6)
    if top_k:
        kth = torch.topk(lg, int(top_k), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full((), -1e30, device=lg.device),
                         lg)
    p = torch.softmax(lg, dim=-1)
    return torch.argmax(p / noise, -1)


def load_reference_state(model: nn.Module, arrays) -> None:
    """Copy a `paddle_tpu` state dict, given as {name: np.ndarray}, into
    `model` (any `nn.Module` whose names match the `paddle_tpu` layer's,
    such as GPTForCausalLM) by parameter and buffer name. `paddle_tpu`
    stores Linear weights [in, out] and PyTorch [out, in], so every
    `nn.Linear` weight is transposed (with the `weight_g`, `weight_v`
    and `weight_orig` that `nn.utils` puts in its place), and so is the
    integer weight of a
    `quantization.WeightOnlyLinear` (int8 [in, out], or int4 packed
    [in, ceil(out / 2)] along the output axis): the JAX package's integers
    and scales are carried across as they are, never re-quantized;
    embeddings and everything else copy as they are. A parameter a rank
    holds a block of (its `partition_spec`: tensor-parallel slices,
    `ep` experts) takes that block of the full array. Raises
    InvalidArgumentError on a missing, extra or mis-shaped key."""
    if any(str(k).startswith("pp::") for k in arrays):
        arrays = _unstack_pipeline(model, arrays)

    def pre(n):
        return f"{n}." if n else ""
    # a Linear's weight, and the weight-norm / spectral-norm parameters
    # that stand for it (`nn.utils`), are the reference's transposed
    linear = {f"{pre(n)}{w}" for n, m in model.named_modules()
              if isinstance(m, nn.Linear)
              for w in ("weight", "weight_g", "weight_v", "weight_orig")}
    linear |= {f"{pre(n)}{qname}" for n, m in model.named_modules()
               if hasattr(m, "quant_weight_spec")
               for qname, _, _ in m.quant_weight_spec()}
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise InvalidArgumentError(
            f"load_reference_state: missing keys {missing}, extra keys "
            f"{extra}")
    specs = {n: q.partition_spec for n, q in model.named_parameters()
             if getattr(q, "partition_spec", None)}
    pairs = []
    for name, p in own.items():
        a = np.asarray(arrays[name])
        a = a.T if name in linear else a
        if tuple(a.shape) != tuple(p.shape) and name in specs:
            # a rank's block of a sharded parameter: cut the full array
            from ..distributed.tensor_parallel import shard_tensor
            a = shard_tensor(torch.from_numpy(np.array(a)),
                             specs[name]).numpy()
        if tuple(a.shape) != tuple(p.shape):
            want = tuple(p.shape)[::-1] if name in linear \
                else tuple(p.shape)
            raise InvalidArgumentError(
                f"load_reference_state: {name} has shape "
                f"{tuple(np.asarray(arrays[name]).shape)}, expected {want}")
        pairs.append((p, a))
    with torch.no_grad():
        for p, a in pairs:
            p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))


def _unstack_pipeline(model, arrays):
    """A `paddle_tpu.parallel.make_pipeline_train_step` state's params
    ({"pp::<block param>": [pp, k, ...], "pre.<name>" / "post.<name>":
    the embedding and head sections' params, as the JAX package names
    them, `parallel/pipeline.py:128-151`) as the model's own names: block
    s * k + j of `pipeline_sections()`'s list takes [s, j] of its
    stack."""
    pre, blocks, post = model.pipeline_sections()
    own = {id(p): n for n, p in model.named_parameters()}
    own_mod = {id(m): n for n, m in model.named_modules()}
    base = own_mod[id(blocks)]
    out = {}
    sections = {"pre": pre, "post": post}
    for key, a in arrays.items():
        key = str(key)
        if key.startswith("pp::"):
            a = np.asarray(a)
            pp, k = a.shape[:2]
            for s_ in range(pp):
                for j in range(k):
                    out[f"{base}.{s_ * k + j}.{key[4:]}"] = a[s_, j]
            continue
        head, _, rest = key.partition(".")
        if head in sections:
            p = dict(sections[head].named_parameters()).get(rest)
            if p is not None:
                out[own[id(p)]] = a
                continue
        out[key] = a
    return out

