"""paddle_tpu_torch's transformer layers held to paddle_tpu's.

Each layer is built in `paddle_tpu` from a seed and copied into the
port's by name (`models.load_reference_state`, Linear weights
transposed); inputs are numpy arrays made from a seed. float32 on the
CPU, dropout 0. Outputs, and every parameter's gradient of a fixed
random projection of the output (the JAX package's eager tape against
torch autograd), agree to rtol 1e-5 / atol 1e-5:
- `MultiHeadAttention`: the fused self-attention path (one GEMM of the
  concatenated q/k/v weights), cross-attention with other key and value
  widths, a `Cache` decoded step by step and a `StaticCache`;
- `TransformerEncoderLayer` (post- and pre-norm), `TransformerEncoder`,
  `TransformerDecoderLayer`, `TransformerDecoder` (also decoding step by
  step through `gen_cache`) and `Transformer`, each with an additive
  [B,1,1,S] key-padding mask and with a boolean one.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_reference_state

E, H, FF = 32, 4, 64
B, S, SM = 2, 12, 10
ATOL = RTOL = 1e-5


def _build(name, *args, **kw):
    paddle.seed(0)
    ref = getattr(jnn, name)(*args, **kw)
    port = getattr(tnn, name)(*args, device="cpu", **kw)
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def _rand(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        "float32")


def _masks(kind, rows=B, keys=S):
    """None, or a key-padding mask [rows, 1, 1, keys] hiding the last keys
    of the second row: additive (-1e30 there) or boolean (True = attend);
    as (JAX tensor, torch tensor)."""
    if kind is None:
        return None, None
    keep = np.ones((rows, 1, 1, keys), bool)
    keep[1, ..., keys - 4:] = False
    m = keep if kind == "bool" else np.where(keep, 0.0, -1e30).astype(
        "float32")
    return paddle.to_tensor(m), torch.from_numpy(m)


def _j(a):
    return paddle.to_tensor(a)


def _t(a):
    return torch.from_numpy(a)


def _close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want.numpy()), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _grads_match(ref, port, jout, tout):
    w = _rand(99, *tout.shape) / np.sqrt(tout.numel())
    (jout * _j(w)).sum().backward()
    (tout * _t(w)).sum().backward()
    want = {n: p.grad for n, p in ref.named_parameters()}
    linear = {f"{n}.weight" for n, m in port.named_modules()
              if isinstance(m, torch.nn.Linear)}
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want) and names
    for n, p in port.named_parameters():
        g = p.grad.detach().numpy()
        _close(g.T if n in linear else g, want[n], n)


@pytest.mark.parametrize("mask", [None, "add", "bool"])
def test_mha_fused_self_attention(mask, monkeypatch):
    ref, port = _build("MultiHeadAttention", E, H)
    x = _rand(1, B, S, E)
    jm, tm = _masks(mask)
    calls = []
    real = tnn.functional.linear
    monkeypatch.setattr(tnn.layer.transformer.F, "linear",
                        lambda *a: calls.append(tuple(a[1].shape))
                        or real(*a))
    xt = _t(x)
    tout = port(xt, attn_mask=tm)
    assert calls == [(E, 3 * E)]   # one GEMM of the fused [E, 3E] weight
    jout = ref(_j(x), attn_mask=jm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)


@pytest.mark.parametrize("mask", [None, "add", "bool"])
def test_mha_cross_attention_other_widths(mask):
    ref, port = _build("MultiHeadAttention", E, H, 0.0, 24, 20)
    q, k, v = _rand(2, B, S, E), _rand(3, B, SM, 24), _rand(4, B, SM, 20)
    jm, tm = _masks(mask, keys=SM)
    jout = ref(_j(q), _j(k), _j(v), jm)
    tout = port(_t(q), _t(k), _t(v), tm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)


def test_mha_cache_decodes_step_by_step():
    ref, port = _build("MultiHeadAttention", E, H)
    x = _rand(5, B, 6, E)
    jc, tc = ref.gen_cache(_j(x)), port.gen_cache(_t(x))
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (B, H, 0, E // H)
    with torch.no_grad():
        for t in range(x.shape[1]):
            step = x[:, t:t + 1]
            jo, jc = ref(_j(step), _j(step), _j(step), None, jc)
            to, tc = port(_t(step), _t(step), _t(step), None, tc)
            _close(to, jo, f"step {t}")
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tuple(tc.k.shape) == (B, H, 6, E // H)


def test_mha_static_cache():
    ref, port = _build("MultiHeadAttention", E, H)
    q, mem = _rand(6, B, S, E), _rand(7, B, SM, E)
    st = tnn.MultiHeadAttention.StaticCache
    jc = ref.gen_cache(_j(mem), _j(mem), type=jnn.MultiHeadAttention
                       .StaticCache)
    tc = port.gen_cache(_t(mem), _t(mem), type=st)
    assert isinstance(tc, st)
    _close(tc.k, jc.k)
    jm, tm = _masks("add", keys=SM)
    jout = ref(_j(q), _j(mem), _j(mem), jm, jc)
    tout = port(_t(q), _t(mem), _t(mem), tm, tc)
    assert torch.is_tensor(tout)   # a static cache is not returned
    _close(tout, jout)


@pytest.mark.parametrize("mask", ["add", "bool"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer(mask, normalize_before):
    ref, port = _build("TransformerEncoderLayer", E, H, FF, 0.0, "gelu",
                       normalize_before=normalize_before)
    x = _rand(8, B, S, E)
    jm, tm = _masks(mask)
    jout, tout = ref(_j(x), jm), port(_t(x), tm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)


def _encoder(normalize_before=False):
    paddle.seed(0)
    jl = jnn.TransformerEncoderLayer(E, H, FF, 0.0, "relu",
                                     normalize_before=normalize_before)
    ref = jnn.TransformerEncoder(jl, 3, jnn.LayerNorm(E))
    tl = tnn.TransformerEncoderLayer(E, H, FF, 0.0, "relu",
                                     normalize_before=normalize_before,
                                     device="cpu")
    port = tnn.TransformerEncoder(tl, 3, tnn.LayerNorm(E, device="cpu"))
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("mask", ["add", "bool"])
def test_encoder_stack(mask):
    ref, port = _encoder()
    assert "layers.2.self_attn.q_proj.weight" in port.state_dict()
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    x = _rand(9, B, S, E)
    jm, tm = _masks(mask)
    jout, tout = ref(_j(x), jm), port(_t(x), tm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)


def test_encoder_cache_path():
    ref, port = _encoder(normalize_before=True)
    x = _rand(10, B, 1, E)
    jc, tc = ref.gen_cache(_j(x)), port.gen_cache(_t(x))
    with torch.no_grad():
        jo, jc = ref(_j(x), None, jc)
        to, tc = port(_t(x), None, tc)
    _close(to, jo)
    assert len(tc) == 3 and tuple(tc[0].k.shape) == (B, H, 1, E // H)


def _causal():
    jm = jnn.Transformer.generate_square_subsequent_mask(S)
    tm = tnn.Transformer.generate_square_subsequent_mask(S, device="cpu")
    _close(tm, jm)
    return jm, tm


@pytest.mark.parametrize("mask", ["add", "bool"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer(mask, normalize_before):
    ref, port = _build("TransformerDecoderLayer", E, H, FF, 0.0,
                       normalize_before=normalize_before)
    tgt, mem = _rand(11, B, S, E), _rand(12, B, SM, E)
    jc, tc = _causal()
    jm, tm = _masks(mask, keys=SM)
    jout = ref(_j(tgt), _j(mem), jc, jm)
    tout = port(_t(tgt), _t(mem), tc, tm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)


def _decoder():
    paddle.seed(0)
    ref = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(E, H, FF, 0.0),
                                 2, jnn.LayerNorm(E))
    port = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(E, H, FF, 0.0, device="cpu"), 2,
        tnn.LayerNorm(E, device="cpu"))
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("mask", ["add", "bool"])
def test_decoder_stack(mask):
    ref, port = _decoder()
    tgt, mem = _rand(13, B, S, E), _rand(14, B, SM, E)
    jc, tc = _causal()
    jm, tm = _masks(mask, keys=SM)
    jout = ref(_j(tgt), _j(mem), jc, jm)
    tout = port(_t(tgt), _t(mem), tc, tm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)


def test_decoder_decodes_step_by_step():
    """Incremental decoding through `gen_cache`: each step's output equals
    the JAX package's, and the last step equals the full causal pass's
    last position."""
    ref, port = _decoder()
    tgt, mem = _rand(15, B, 5, E), _rand(16, B, SM, E)
    jcache, tcache = ref.gen_cache(_j(mem)), port.gen_cache(_t(mem))
    with torch.no_grad():
        for t in range(tgt.shape[1]):
            step = tgt[:, t:t + 1]
            jo, jcache = ref(_j(step), _j(mem), None, None, jcache)
            to, tcache = port(_t(step), _t(mem), None, None, tcache)
            _close(to, jo, f"step {t}")
        full = port(_t(tgt), _t(mem), tnn.Transformer
                    .generate_square_subsequent_mask(5, device="cpu"), None)
    torch.testing.assert_close(to[:, 0], full[:, -1], atol=ATOL, rtol=RTOL)
    zipped = port.gen_cache(_t(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


@pytest.mark.parametrize("mask", ["add", "bool"])
def test_transformer(mask):
    ref, port = _build("Transformer", E, H, 2, 2, FF, 0.0)
    src, tgt = _rand(17, B, SM, E), _rand(18, B, S, E)
    jm, tm = _masks(mask, keys=SM)
    jc, tc = _causal()
    jout = ref(_j(src), _j(tgt), jm, jc, jm)
    tout = port(_t(src), _t(tgt), tm, tc, tm)
    _close(tout, jout)
    _grads_match(ref, port, jout, tout)
