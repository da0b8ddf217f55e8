"""GPT-style causal decoder (port of `paddle_tpu.models.gpt`).

The layer classes keep the JAX package's attribute names (`gpt.wte`,
`gpt.wpe`, `gpt.blocks.{i}.ln1`, `.attn.{q,k,v,out}_proj`, `.ln2`,
`.mlp.{0,2}`, `gpt.ln_f`), so `load_reference_state` can copy a
`paddle_tpu` state dict across by name.

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
`F.linear`; the JAX package stores `[in, out]`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from ..framework.errors import InvalidArgumentError
from ..framework.place import resolve_device
from ..nn.functional import scaled_dot_product_attention
from ..nn.layer import GELU, Dropout, Embedding, LayerNorm, Linear
from ..ops.linalg import matmul
from ..ops.paged_ops import cached_attention

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_prefill",
           "gpt_decode_step", "gpt_logits", "dense_cache_write",
           "dense_cache_attend", "load_reference_state"]


# -- shared decode math (generate() AND serving.GenerationEngine) -----------

def _gen_ln(x, w, b):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - m) / torch.sqrt(v + 1e-5) * w + b


def gpt_logits(W, h):
    """Final LN + tied LM head over hidden states `h` [..., E]."""
    lnfw, lnfb = W["lnf"]
    return TF.linear(_gen_ln(h, lnfw, lnfb), W["wte"])


def _gen_block_pass(W, h, attend, *, num_heads):
    """The batched transformer-block loop of a prefill: LN -> QKV heads
    -> `attend(layer, q, k, v)` -> output projection + MLP residuals,
    collecting per-layer K/V. Returns `(h, ks, vs)`, ks/vs
    [L, B, H, S, D]."""
    B, S = h.shape[:2]
    H = num_heads
    ks, vs = [], []
    for i, (l1w, l1b, wq, bq, wk, bk, wv, bv, wo, bo, l2w, l2b,
            w1, b1, w2, b2) in enumerate(W["blocks"]):
        x = _gen_ln(h, l1w, l1b)

        def heads(t):
            return t.reshape(B, S, H, -1).transpose(1, 2)
        q = heads(TF.linear(x, wq, bq))
        k = heads(TF.linear(x, wk, bk))
        v = heads(TF.linear(x, wv, bv))
        ks.append(k)
        vs.append(v)
        o = attend(i, q, k, v)
        o = o.transpose(1, 2).reshape(B, S, -1)
        h = h + TF.linear(o, wo, bo)
        x2 = _gen_ln(h, l2w, l2b)
        h = h + TF.linear(TF.gelu(TF.linear(x2, w1, b1)), w2, b2)
    return h, torch.stack(ks), torch.stack(vs)


def gpt_prefill(W, ids, *, num_heads, scale):
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

    return _gen_block_pass(W, h, attend, num_heads=num_heads)


def gpt_decode_step(W, tok, pos, cache, write_kv, attend, *, num_heads,
                    scale):
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
        q = TF.linear(x, wq, bq).reshape(B, H, -1)
        k = TF.linear(x, wk, bk).reshape(B, H, -1)
        v = TF.linear(x, wv, bv).reshape(B, H, -1)
        cache = write_kv(cache, i, k, v, pos)
        o = attend(cache, i, q, pos).reshape(B, -1)
        h = h + TF.linear(o, wo, bo)
        x2 = _gen_ln(h, l2w, l2b)
        h = h + TF.linear(TF.gelu(TF.linear(x2, w1, b1)), w2, b2)
    return gpt_logits(W, h), cache


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

    def forward(self, x):
        b, s, e = x.shape

        def shape(t):
            return t.reshape(b, s, self.num_heads, self.head_dim) \
                .transpose(1, 2)
        out = scaled_dot_product_attention(
            shape(self.q_proj(x)), shape(self.k_proj(x)),
            shape(self.v_proj(x)), is_causal=True, dropout_p=self.dropout,
            training=self.training)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, e))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        if cfg.use_moe:
            raise InvalidArgumentError(
                "MoE blocks (MoEFeedForward) are not yet ported")
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(cfg.hidden_size, **kw)
        self.attn = CausalSelfAttention(cfg, **kw)
        self.ln2 = LayerNorm(cfg.hidden_size, **kw)
        self.mlp = nn.Sequential(
            Linear(cfg.hidden_size, cfg.intermediate_size, **kw),
            GELU(),
            Linear(cfg.intermediate_size, cfg.hidden_size, **kw))
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln1(x)))
        x = x + self.dropout(self.mlp(self.ln2(x)))
        return x


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

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None]
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            h = blk(h)
        return self.ln_f(h)


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
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=g)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids):
        return matmul(self.gpt(input_ids), self.gpt.wte.weight,
                      transpose_y=True)

    def decode_weights(self):
        """The decode-math weight dict shared by `generate()` and
        `serving.GenerationEngine` (detached parameter tensors, Linear
        weights in PyTorch's [out, in] layout)."""
        gpt = self.gpt
        if gpt.config.use_moe:
            raise NotImplementedError("generate() with MoE blocks")

        def lin(m):
            return m.weight.detach(), m.bias.detach()

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


def load_reference_state(model: nn.Module, arrays) -> None:
    """Copy a `paddle_tpu` state dict, given as {name: np.ndarray}, into
    `model` (any `nn.Module` whose names match the `paddle_tpu` layer's,
    such as GPTForCausalLM) by parameter name. `paddle_tpu` stores Linear
    weights [in, out] and PyTorch [out, in], so every `nn.Linear` weight
    is transposed; embeddings and everything else copy as they are.
    Raises InvalidArgumentError on a missing, extra or mis-shaped key."""
    linear = {f"{n}.weight" if n else "weight"
              for n, m in model.named_modules() if isinstance(m, nn.Linear)}
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise InvalidArgumentError(
            f"load_reference_state: missing keys {missing}, extra keys "
            f"{extra}")
    pairs = []
    for name, p in own.items():
        a = np.asarray(arrays[name])
        want = tuple(p.shape)[::-1] if name in linear else tuple(p.shape)
        if tuple(a.shape) != want:
            raise InvalidArgumentError(
                f"load_reference_state: {name} has shape {tuple(a.shape)}, "
                f"expected {want}")
        pairs.append((p, a.T if name in linear else a))
    with torch.no_grad():
        for p, a in pairs:
            p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))
