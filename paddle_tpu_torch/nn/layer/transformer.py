"""Transformer layers (port of `paddle_tpu.nn.layer.transformer`; reference
`python/paddle/nn/layer/transformer.py`: MultiHeadAttention:87,
TransformerEncoderLayer, TransformerEncoder, TransformerDecoder*,
Transformer).

Attention goes through `F.scaled_dot_product_attention`, so a [B,1,1,S]
key-padding mask (or no mask) at S >= FLAGS_flash_attention_min_seq
reaches `ops.flash_ops.flash_attention`: kernels K2-K4 on a CUDA
tensor, their plain versions on a CPU one. Parameter names are the JAX
package's (`self_attn.q_proj.weight`, `linear1`, `norm1`, ...), with
PyTorch's [out, in] Linear layout (`models.load_reference_state`
transposes). Every constructor takes `device=` and `dtype=` keywords
after the JAX package's arguments; `weight_attr` / `bias_attr` reach
each `Linear` as keywords."""
from __future__ import annotations

import collections
import contextlib
import copy

import torch
from torch import nn

from ...framework.place import resolve_device
from ...ops import flash_ops
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    """reference `nn/layer/transformer.py:87`. `Cache` (k, v) grows by
    the new step's keys and values at each call (incremental decoding);
    `StaticCache` holds the projected keys and values of a fixed memory
    (cross-attention).

    Tensor parallel (`distributed.tensor_parallel.shard_megatron`, set by
    `models.ernie.tp_annotate`): `tp` = (axis, n, r) and the projections
    hold rank r's heads [r*H/n, (r+1)*H/n) (q/k/v column-parallel,
    out_proj row-parallel); the layer attends over those heads, their
    dropout drawn as the whole model's (`ops.flash_ops.head_shard`)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = dict(device=device, dtype=dtype, weight_attr=weight_attr,
                  bias_attr=bias_attr)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
        self.tp = None

    @property
    def local_heads(self):
        return self.num_heads // (self.tp[1] if self.tp else 1)

    def _shape(self, x):
        # [B, S, E] -> [B, H, S, D] (this rank's heads under tp)
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.local_heads, self.head_dim) \
            .transpose(1, 2)

    def gen_cache(self, key, value=None, type=None):
        """A `StaticCache` of `key`'s (and `value`'s) projections when
        `type` is `StaticCache`, else an empty `Cache` ([B, H, 0, D]) in
        `key`'s type on its device."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], self.local_heads, 0,
                            self.head_dim, dtype=key.dtype,
                            device=key.device)
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        fuse_qkv = (key is query and value is query and cache is None
                    and self.kdim == self.embed_dim
                    and self.vdim == self.embed_dim)
        if fuse_qkv:
            # self-attention: one GEMM of the concatenated [3E, E] weights;
            # the three projections stay separate parameters (their
            # gradients flow through the concatenation)
            w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight], dim=0)
            b = (None if self.q_proj.bias is None else
                 torch.cat([self.q_proj.bias, self.k_proj.bias,
                            self.v_proj.bias], dim=0))
            if self.tp is not None:
                # the column slices' input, entering once for the three
                from ...distributed.tensor_parallel import (_CopyToParallel,
                                                            _axis)
                query = _CopyToParallel.apply(query, _axis(self.tp[0])[0])
            qkv = F.linear(query, w.t(), b)
            q, k, v = (self._shape(t)
                       for t in torch.split(qkv, w.shape[0] // 3, dim=-1))
        else:
            q = self._shape(self.q_proj(query))
            if isinstance(cache, self.StaticCache):
                k, v = cache.k, cache.v
            else:
                k = self._shape(self.k_proj(key))
                v = self._shape(self.v_proj(value))
                if isinstance(cache, self.Cache):
                    k = torch.cat([cache.k, k], dim=2)
                    v = torch.cat([cache.v, v], dim=2)
                    cache = self.Cache(k, v)
        with (flash_ops.head_shard(self.tp[2] * self.local_heads,
                                   self.num_heads)
              if self.tp is not None else contextlib.nullcontext()):
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
        b, s = query.shape[0], query.shape[1]
        out = self.out_proj(out.transpose(1, 2).reshape(
            b, s, self.local_heads * self.head_dim))
        if isinstance(cache, self.Cache):
            return out, cache
        return out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        dev = dict(device=device, dtype=dtype)
        kw = dict(dev, weight_attr=weight_attr, bias_attr=bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **dev)
        self.norm2 = LayerNorm(d_model, **dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """`num_layers` copies of `encoder_layer` (the first is the layer
    itself, the rest deep copies, as in the JAX package: they start with
    its weights), then `norm` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        dev = dict(device=device, dtype=dtype)
        kw = dict(dev, weight_attr=weight_attr, bias_attr=bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **dev)
        self.norm2 = LayerNorm(d_model, **dev)
        self.norm3 = LayerNorm(d_model, **dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """`num_layers` copies of `decoder_layer` (deep copies after the
    first, as `TransformerEncoder`), then `norm` when given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **dev)
            enc_norm = LayerNorm(d_model, **dev) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **dev)
            dec_norm = LayerNorm(d_model, **dev) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """float32 [length, length]: 0 on and below the diagonal, -1e30
        above it. On `device` (the CUDA card unless given)."""
        dev = resolve_device(device)
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=dev).tril()
        return torch.where(keep, torch.zeros((), device=dev),
                           torch.full((), -1e30, device=dev))
