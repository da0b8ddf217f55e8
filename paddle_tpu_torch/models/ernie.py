"""ERNIE/BERT-family encoder (port of `paddle_tpu.models.ernie`; capability
target PaddleNLP ERNIE-base).

The layer classes keep the JAX package's attribute names
(`ernie.embeddings.word_embeddings`, `ernie.encoder.layers.{i}.self_attn.
q_proj`, `.linear1`, `.norm1`, `ernie.pooler.dense`, `classifier`,
`mlm_transform`, `mlm_bias`, `nsp`, ...), so `load_reference_state`
copies a `paddle_tpu` state dict across by name. The encoder is the
port's `nn.TransformerEncoder`: its self-attention takes the fused QKV
GEMM, and a [B,1,1,S] key-padding mask at S >= the flash minimum reaches
the flash kernels (K2 forward, K3 + K4 backward).

Each model is built on `device` (the CUDA card unless the caller passes
another; raises where there is none) with every parameter drawn from one
`torch.Generator` seeded with `seed`, by the JAX package's initializers:
embeddings normal(0, initializer_range), Linear weights Xavier-uniform,
biases (and `mlm_bias`) zero, LayerNorms one and zero. Every encoder
layer gets its own draw (the JAX package's `TransformerEncoder` starts
its layers as copies of the first)."""
from __future__ import annotations

import torch
from torch import nn

from ..framework.place import resolve_device
from ..nn import initializer as I
from ..nn.layer import (GELU, Dropout, Embedding, LayerNorm, Linear, Tanh,
                        TransformerEncoder, TransformerEncoderLayer)
from ..ops.linalg import matmul

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForPretraining", "ErniePooler", "tp_annotate"]


class ErnieConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=256,
                   max_position_embeddings=128)


@torch.no_grad()
def _init_weights(model, seed, initializer_range):
    """Draw every parameter of `model` from one generator seeded with
    `seed`, in module order (see the module docstring)."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(
        int(seed))
    normal = I.Normal(0.0, initializer_range)
    xavier = I.XavierUniform()
    zero, one = I.Constant(0.0), I.Constant(1.0)
    for mod in model.modules():
        if isinstance(mod, nn.Embedding):
            normal(mod.weight, generator=g)
        elif isinstance(mod, nn.Linear):
            xavier(mod.weight.t(), generator=g)   # the [in, out] fans
            if mod.bias is not None:
                zero(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            one(mod.weight)
            zero(mod.bias)
    if isinstance(getattr(model, "mlm_bias", None), nn.Parameter):
        zero(model.mlm_bias)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=1e-12, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape[0], input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int64, device=input_ids.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErniePooler(nn.Module):
    def __init__(self, hidden_size, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, device=device,
                            dtype=dtype)
        self.activation = Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class ErnieModel(nn.Module):
    """Embeddings, the encoder and the pooler. `forward` returns
    (sequence output [B, S, E], pooled [B, E]); a 2-D 1/0
    `attention_mask` becomes the additive float32 [B, 1, 1, S] mask
    (1 - m) * -1e4. `seed` None leaves the draw to the caller: the heads
    draw their whole tree, this model included, once."""

    def __init__(self, cfg: ErnieConfig = None, device=None, dtype=None,
                 seed: int | None = 0, **kwargs):
        super().__init__()
        cfg = cfg or ErnieConfig(**kwargs)
        self.config = cfg
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, act_dropout=0.0,
            **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = ErniePooler(cfg.hidden_size, **kw)
        if seed is not None:
            _init_weights(self, seed, cfg.initializer_range)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            am = attention_mask[:, None, None, :]
            attention_mask = (1.0 - am.to(torch.float32)) * -1e4
        out = self.encoder(emb, attention_mask)
        return out, self.pooler(out)


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, cfg: ErnieConfig = None, num_classes=2, dropout=None,
                 device=None, dtype=None, seed: int = 0, **kwargs):
        super().__init__()
        self.ernie = ErnieModel(cfg, device=device, dtype=dtype, seed=None,
                                **kwargs)
        c = self.ernie.config
        self.dropout = Dropout(dropout if dropout is not None
                               else c.hidden_dropout_prob)
        self.classifier = Linear(c.hidden_size, num_classes,
                                 device=self.ernie.device, dtype=dtype)
        _init_weights(self, seed, c.initializer_range)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForPretraining(nn.Module):
    """MLM + NSP heads. The MLM head is tied to the word embeddings:
    logits = h E^T + mlm_bias (`ops.linalg.matmul`, AMP's "matmul")."""

    def __init__(self, cfg: ErnieConfig = None, device=None, dtype=None,
                 seed: int = 0, **kwargs):
        super().__init__()
        self.ernie = ErnieModel(cfg, device=device, dtype=dtype, seed=None,
                                **kwargs)
        c = self.ernie.config
        kw = dict(device=self.ernie.device, dtype=dtype)
        self.mlm_transform = Linear(c.hidden_size, c.hidden_size, **kw)
        self.mlm_norm = LayerNorm(c.hidden_size, eps=1e-12, **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(c.vocab_size, **kw))
        self.nsp = Linear(c.hidden_size, 2, **kw)
        self.act = GELU()
        _init_weights(self, seed, c.initializer_range)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        h = self.mlm_norm(self.act(self.mlm_transform(seq)))
        emb = self.ernie.embeddings.word_embeddings
        if getattr(emb, "_mp_split", False):
            # a vocab-parallel table: this rank's logits, gathered over
            # 'mp' (the reference's result is global)
            from ..distributed.tensor_parallel import (
                _axis, _CopyToParallel, _GatherFromParallel)
            group, n, r = _axis()
            if n > 1:
                part = matmul(_CopyToParallel.apply(h, group), emb.weight,
                              transpose_y=True)
                logits = _GatherFromParallel.apply(part, group, n, r)
                return logits + self.mlm_bias, self.nsp(pooled)
        logits = matmul(h, emb.weight, transpose_y=True) + self.mlm_bias
        return logits, self.nsp(pooled)


_COLUMN = ("q_proj", "k_proj", "v_proj", "linear1")
_ROW = ("out_proj", "linear2")
_VOCAB = ("word_embeddings", "embed_tokens")


def tp_annotate(layer):
    """Megatron-style tensor parallelism on a Transformer(-Encoder/Decoder)
    stack, by module name as the JAX package marks its specs
    (`paddle_tpu/models/ernie.py:160-182`): `q_proj`, `k_proj`, `v_proj`
    and `linear1` column-parallel (weight and bias), `out_proj` and
    `linear2` row-parallel, `word_embeddings` / `embed_tokens`
    vocab-parallel. The JAX package keeps the full weights and lets GSPMD
    partition the forward; the port cuts each marked module, in place, to
    this rank's slice of the current mesh's 'mp' axis (`distributed.
    tensor_parallel.shard_megatron`: the full weights are cut as
    `shard_tensor` cuts them, so a seeded run starts from one full
    weight) and each `MultiHeadAttention` attends over its rank's heads.
    With no 'mp' axis, or 'mp' 1, it only sets `partition_spec`;
    `fleet.distributed_model` cuts the model later on a mesh with 'mp'.
    Returns `layer`."""
    from ..distributed.tensor_parallel import mark_megatron, shard_megatron
    for name, mod in layer.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, nn.Linear) and leaf in _COLUMN:
            mark_megatron(mod, "column")
        elif isinstance(mod, nn.Linear) and leaf in _ROW:
            mark_megatron(mod, "row")
        elif isinstance(mod, nn.Embedding) and leaf in _VOCAB:
            mark_megatron(mod, "vocab")
    return shard_megatron(layer)
