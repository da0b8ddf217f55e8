"""paddle_tpu_torch.onnx.export held to paddle_tpu.onnx.export.

Every case of `tests/test_onnx_export.py`, on the port's exporter: the
MLP, the initializer round trip, the conv/pool graph, the output shape
metadata, the embedding-attention block, the LSTM refusal and the wire
format. Each model is also built in the JAX package from a seed, its
weights carried into the port by `models.load_reference_state`, and both
packages' `.onnx` files are evaluated by `torch_onnx_eval` (numpy) on the
same seeded inputs: each within 1e-5 x max(1, max |ref|) of the JAX
forward and of the other export. Initializers hold each package's own
tensors under the `state_dict` names (a port Linear weight [out, in]),
so they are compared to their own package's state, never byte for byte
across packages.

ERNIE: a 2-layer ERNIE (hidden 64, 4 heads of 16) classifier at [2, 128]
with a key-padding mask, the same two ways, and the initializer name
sets equal. The JAX exporter has no mapping for `split` (its fused qkv)
nor for `erfc` (its GELU), so it refuses its own ERNIE (ROADMAP C42):
the parity test gives it both for the test's duration (`jax_gaps`), and
`test_jax_exporter_refuses_its_fused_qkv` shows the refusal. With FLAGS_flash_attention_min_seq at 128 the port's trace
holds `paddle_tpu_torch::flash_fwd` (its CPU plain version), which the
exporter lowers to MatMul / Softmax / MatMul: the graph holds no custom
op and evaluates within the same limit.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.onnx import export as jexport
from paddle_tpu.static import InputSpec as JSpec
import paddle_tpu_torch as ptt
from paddle_tpu_torch import models, nn
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.onnx import UnsupportedOnnxExport, export, proto, wire
from paddle_tpu_torch.static import InputSpec

sys.path.insert(0, os.path.dirname(__file__))
import torch_onnx_eval  # noqa: E402

TOL = 1e-5
EXPORT_MOD = sys.modules["paddle_tpu_torch.onnx.export"]


@pytest.fixture(autouse=True)
def on_the_cpu():
    before = ptt.framework.place.default_place()
    ptt.set_device("cpu")
    yield
    ptt.set_device(before)


def _decode_model(path):
    with open(path, "rb") as f:
        buf = f.read()
    model = wire.decode(buf)
    assert model[1][0] == 7                      # ir_version
    assert b"paddle_tpu_torch" in model[2][0]    # producer
    graph = wire.decode(model[7][0])
    opset = wire.decode(model[8][0])
    assert opset[2][0] == 13
    nodes = [wire.decode(n) for n in graph.get(1, [])]
    inits = [wire.decode(t) for t in graph.get(5, [])]
    inputs = [wire.decode(v) for v in graph.get(11, [])]
    outputs = [wire.decode(v) for v in graph.get(12, [])]
    return graph, nodes, inits, inputs, outputs


def _check_wellformed(nodes, inits, inputs):
    available = {i[8][0].decode() for i in inits if 8 in i}
    available |= {v[1][0].decode() for v in inputs}
    for n in nodes:
        for inp in n.get(1, []):
            assert inp.decode() in available, \
                f"node {n[4][0].decode()} consumes undefined {inp!r}"
        for out in n.get(2, []):
            available.add(out.decode())
    return available


def _op_types(nodes):
    return [n[4][0].decode() for n in nodes]


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    lim = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= lim, (err, lim)


def _arrays(net):
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _both(jnet, tnet, tmp_path, jspecs, tspecs, feeds, tag):
    """Export both models, evaluate both files on `feeds` and hold each to
    the JAX forward and to the other; returns the two loaded models."""
    jnet.eval()
    tnet.eval()
    jp = jexport(jnet, str(tmp_path / f"{tag}_jax"), input_spec=jspecs)
    tp = export(tnet, str(tmp_path / f"{tag}_port"), input_spec=tspecs)
    jm, tm = torch_onnx_eval.load(jp), torch_onnx_eval.load(tp)
    jfeed = {s.name: np.asarray(f).astype(s.dtype)
             for s, f in zip(jspecs, feeds)}
    tfeed = {s.name: np.asarray(f).astype(s.dtype)
             for s, f in zip(tspecs, feeds)}
    ref = jnet(*[paddle.to_tensor(jfeed[s.name]) for s in jspecs]).numpy()
    jo = jm.run(jfeed)[0]
    to = tm.run(tfeed)[0]
    with torch.no_grad():
        eager = tnet(*[torch.from_numpy(tfeed[s.name]) for s in tspecs])
    _close(jo, ref)
    _close(to, ref)
    _close(to, jo)
    _close(to, eager.numpy())
    return jm, tm


def _mlp_pair():
    paddle.seed(11)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.LayerNorm(16),
                          jnn.Linear(16, 4), jnn.Softmax())
    tnet = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.LayerNorm(16),
                         nn.Linear(16, 4), nn.Softmax())
    load_reference_state(tnet, _arrays(jnet))
    return jnet, tnet


class TestOnnxExportMLP:
    def test_mlp_structure(self, tmp_path):
        jnet, model = _mlp_pair()
        x = np.random.RandomState(0).standard_normal((2, 8))
        _both(jnet, model, tmp_path, [JSpec([2, 8], "float32", "x")],
              [InputSpec([2, 8], "float32", "x")], [x], "mlp")
        path = str(tmp_path / "mlp_port.onnx")
        graph, nodes, inits, inputs, outputs = _decode_model(path)
        assert len(inputs) == 1 and inputs[0][1][0] == b"x"
        assert len(outputs) == 1
        _check_wellformed(nodes, inits, inputs)
        ops = _op_types(nodes)
        # a Linear is one Gemm reading its [out, in] weight (transB=1);
        # layer_norm decomposes, softmax stays one op
        assert ops.count("Gemm") == 2 and "Transpose" not in ops
        assert "Relu" in ops and "Softmax" in ops
        assert "ReduceMean" in ops and "Sqrt" in ops
        init_names = {i[8][0].decode() for i in inits if 8 in i}
        for pname in model.state_dict():
            assert pname in init_names

    def test_initializer_bytes_roundtrip(self, tmp_path):
        lin = nn.Linear(3, 2)
        lin.eval()
        path = export(lin, str(tmp_path / "lin"),
                      input_spec=[InputSpec([1, 3], "float32", "x")])
        _, nodes, inits, inputs, _ = _decode_model(path)
        by_name = {i[8][0].decode(): i for i in inits if 8 in i}
        w = by_name["weight"]
        assert w[2][0] == 1                      # FLOAT
        assert w[1] == [2, 3]                    # the port's [out, in]
        arr = np.frombuffer(w[9][0], "<f4").reshape(w[1])
        assert np.array_equal(arr, lin.weight.detach().numpy())
        gemm = nodes[_op_types(nodes).index("Gemm")]
        attrs = {wire.decode(a)[1][0].decode(): wire.decode(a)
                 for a in gemm.get(5, [])}
        assert attrs["transB"][3][0] == 1
        assert [i.decode() for i in gemm[1]][1:] == ["weight", "bias"]

    def test_bfloat16_initializers_are_float32(self, tmp_path):
        lin = nn.Linear(4, 3).to(torch.bfloat16).eval()
        path = export(lin, str(tmp_path / "lin16"),
                      input_spec=[InputSpec([2, 4], "bfloat16", "x")])
        _, _, inits, inputs, outputs = _decode_model(path)
        w = {i[8][0].decode(): i for i in inits if 8 in i}["weight"]
        assert w[2][0] == 1
        arr = np.frombuffer(w[9][0], "<f4").reshape(w[1])
        assert np.array_equal(arr, lin.weight.detach().float().numpy())
        x = np.random.RandomState(1).standard_normal((2, 4)).astype(
            np.float32)
        got = torch_onnx_eval.run(path, {"x": x})[0]
        ref = (torch.from_numpy(x) @ lin.weight.float().T
               + lin.bias.float()).detach().numpy()
        _close(got, ref)


def _cnn_pair(j, t):
    def build(m):
        return m.Sequential(
            m.Conv2D(1, 4, 3, padding=1), m.ReLU(), m.MaxPool2D(2, 2),
            m.Conv2D(4, 8, 3, stride=2), m.Sigmoid(), m.AvgPool2D(2, 2),
            m.Flatten(), m.Linear(8 * 3 * 3, 5))
    paddle.seed(12)
    jnet, tnet = build(j), build(t)
    load_reference_state(tnet, _arrays(jnet))
    return jnet, tnet


class TestOnnxExportCNN:
    def test_conv_pool_graph(self, tmp_path):
        jnet, model = _cnn_pair(jnn, nn)
        x = np.random.RandomState(2).standard_normal((1, 1, 28, 28))
        _both(jnet, model, tmp_path, [JSpec([1, 1, 28, 28], "float32",
                                            "img")],
              [InputSpec([1, 1, 28, 28], "float32", "img")], [x], "cnn")
        _, nodes, inits, inputs, outputs = _decode_model(
            str(tmp_path / "cnn_port.onnx"))
        _check_wellformed(nodes, inits, inputs)
        ops = _op_types(nodes)
        assert ops.count("Conv") == 2
        assert "MaxPool" in ops
        assert "AveragePool" in ops
        assert "Sigmoid" in ops
        conv = nodes[ops.index("Conv")]
        attrs = {wire.decode(a)[1][0].decode(): wire.decode(a)
                 for a in conv.get(5, [])}
        assert attrs["strides"][8] == [1, 1]
        assert attrs["pads"][8] == [1, 1, 1, 1]

    def test_output_shape_metadata(self, tmp_path):
        model = nn.Sequential(nn.Conv2D(3, 2, 1), nn.Flatten(),
                              nn.Linear(2 * 4 * 4, 7))
        model.eval()
        path = export(model, str(tmp_path / "m"),
                      input_spec=[InputSpec([2, 3, 4, 4], "float32", "x")])
        _, _, _, _, outputs = _decode_model(path)
        ty = wire.decode(outputs[0][2][0])
        tensor_ty = wire.decode(ty[1][0])
        assert tensor_ty[1][0] == 1              # float32
        shape = wire.decode(tensor_ty[2][0])
        dims = [wire.decode(d)[1][0] for d in shape[1]]
        assert dims == [2, 7]


def _mini(pkg, m):
    class Mini(m.Layer):
        def __init__(self):
            super().__init__()
            self.emb = m.Embedding(50, 16)
            self.q = m.Linear(16, 16)
            self.k = m.Linear(16, 16)
            self.v = m.Linear(16, 16)
            self.norm = m.LayerNorm(16)

        def forward(self, ids):
            h = self.emb(ids)
            q, k, v = self.q(h), self.k(h), self.v(h)
            att = pkg.nn.functional.softmax(
                pkg.matmul(q, k, transpose_y=True) / 4.0)
            return self.norm(pkg.matmul(att, v) + h)
    return Mini()


class TestOnnxExportTransformerish:
    def test_embedding_attention_block(self, tmp_path):
        paddle.seed(13)
        jnet, model = _mini(paddle, jnn), _mini(ptt, nn)
        load_reference_state(model, _arrays(jnet))
        ids = np.random.RandomState(3).randint(0, 50, (2, 6))
        _both(jnet, model, tmp_path, [JSpec([2, 6], "int32", "ids")],
              [InputSpec([2, 6], "int64", "ids")], [ids], "attn")
        _, nodes, inits, inputs, _ = _decode_model(
            str(tmp_path / "attn_port.onnx"))
        _check_wellformed(nodes, inits, inputs)
        ops = _op_types(nodes)
        assert "Gather" in ops                   # embedding lookup
        # q, k, v (Gemm) and the two attention products (MatMul)
        assert ops.count("Gemm") + ops.count("MatMul") >= 5
        assert "Sqrt" in ops or "Div" in ops     # layernorm denominator

    def test_unsupported_raises(self, tmp_path):
        class Scanny(nn.Layer):
            def __init__(self):
                super().__init__()
                self.rnn = nn.LSTM(4, 4)

            def forward(self, x):
                out, _ = self.rnn(x)
                return out

        model = Scanny()
        model.eval()
        with pytest.raises(UnsupportedOnnxExport, match="lstm"):
            export(model, str(tmp_path / "rnn"),
                   input_spec=[InputSpec([1, 5, 4], "float32", "x")])
        assert not (tmp_path / "rnn.onnx").exists()


class TestExportSurface:
    def test_refusals_and_opset(self, tmp_path):
        with pytest.raises(TypeError):
            export(lambda x: x, str(tmp_path / "f"),
                   input_spec=[InputSpec([1], "float32")])
        with pytest.raises(ValueError):
            export(nn.Linear(2, 2), str(tmp_path / "g"))
        with pytest.warns(UserWarning, match="opset"):
            path = export(nn.Linear(2, 2), str(tmp_path / "h"),
                          input_spec=[InputSpec([None, 2], "float32")],
                          opset_version=11)
        _, _, _, inputs, outputs = _decode_model(path)
        # None collapses to 1, as _spec_to_sds without a scope
        ty = wire.decode(wire.decode(inputs[0][2][0])[1][0])
        dims = [wire.decode(d)[1][0]
                for d in wire.decode(ty[2][0])[1]]
        assert dims == [1, 2] and inputs[0][1][0] == b"x0"

    def test_training_mode_restored(self, tmp_path):
        net = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
        net.train()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            export(net, str(tmp_path / "d"),
                   input_spec=[InputSpec([3, 2], "float32", "x")])
        assert net.training


class TestWireFormat:
    def test_varint_roundtrip(self):
        for n in (0, 1, 127, 128, 300, 2 ** 32, 2 ** 60, -1, -42):
            assert wire.varint(n) == paddle.onnx.wire.varint(n)
            dec = wire.decode(wire.field_varint(3, n))
            want = n if n >= 0 else n + (1 << 64)
            assert dec[3][0] == want

    def test_tensor_proto_dtypes(self):
        for dt in ("float32", "int64", "int32", "bool", "float16"):
            arr = np.ones((2, 3), dt)
            msg = wire.decode(proto.tensor_proto("t", arr))
            assert msg[1] == [2, 3]
            assert msg[2][0] == proto.DTYPE_MAP[dt]
            assert msg[8][0] == b"t"
            assert len(msg[9][0]) == arr.nbytes
            assert proto.tensor_proto("t", arr) == \
                paddle.onnx.proto.tensor_proto("t", arr)

    def test_same_bytes_as_the_reference(self):
        from paddle_tpu.onnx import proto as jproto
        n = proto.node_proto("Gemm", ["a", "b"], ["c"], "g",
                             {"transB": 1, "alpha": 0.5, "perm": [1, 0]})
        assert n == jproto.node_proto("Gemm", ["a", "b"], ["c"], "g",
                                      {"transB": 1, "alpha": 0.5,
                                       "perm": [1, 0]})
        g = proto.graph_proto([n], "g", [], [], [])
        assert proto.model_proto(g) == jproto.model_proto(
            g, producer="paddle_tpu_torch")


# -- ERNIE ------------------------------------------------------------------------

ERNIE_KW = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=256, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
B, S = 2, 128


@pytest.fixture
def jax_gaps(monkeypatch):
    """ONNX forms of the JAX exporter's `split` and `erfc` primitives, for
    this test only (ROADMAP C42: its table has neither): a `Split`, and
    1 - `Erf`, as its other ops are written."""
    jexp_mod = sys.modules["paddle_tpu.onnx.export"]

    def erfc(conv, eqn):
        x = conv.name_of(eqn.invars[0])
        one = conv.add_initializer(
            np.ones((), eqn.invars[0].aval.dtype), "one")
        tmp = conv.fresh("erf")
        conv.emit("Erf", [x], [tmp])
        conv.emit1("Sub", [one, tmp], eqn)
    monkeypatch.setitem(jexp_mod._HANDLERS, "erfc", erfc)

    def split(conv, eqn):
        x = conv.name_of(eqn.invars[0])
        sizes = conv.add_initializer(
            np.asarray(eqn.params["sizes"], np.int64), "split")
        outs = [conv.name_for_out(v) for v in eqn.outvars]
        conv.emit("Split", [x, sizes], outs,
                  {"axis": int(eqn.params["axis"])})
    monkeypatch.setitem(jexp_mod._HANDLERS, "split", split)


class _JWrap(jnn.Layer):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, ids, mask):
        return self.net(ids, attention_mask=mask)


class _TWrap(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, ids, mask):
        return self.net(ids, attention_mask=mask)


def _ernie_pair():
    paddle.seed(3)
    jnet = jmodels.ErnieForSequenceClassification(
        jmodels.ErnieConfig(**ERNIE_KW), 2)
    tnet = models.ErnieForSequenceClassification(
        models.ErnieConfig(**ERNIE_KW), 2, device="cpu")
    load_reference_state(tnet, _arrays(jnet))
    return _JWrap(jnet), _TWrap(tnet)


def _ernie_feeds():
    rng = np.random.RandomState(7)
    lens = rng.randint(40, S + 1, size=B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
    ids = rng.randint(1, ERNIE_KW["vocab_size"], size=(B, S))
    ids[mask == 0] = 0
    return ids, mask


def _ernie_specs():
    return ([JSpec([B, S], "int32", "ids"), JSpec([B, S], "int32", "mask")],
            [InputSpec([B, S], "int64", "ids"),
             InputSpec([B, S], "int64", "mask")])


def test_ernie_matches_jax_export_and_forward(tmp_path, jax_gaps):
    jnet, tnet = _ernie_pair()
    jspecs, tspecs = _ernie_specs()
    jm, tm = _both(jnet, tnet, tmp_path, jspecs, tspecs, _ernie_feeds(),
                   "ernie")
    state = set(tnet.state_dict())
    assert set(jnet.state_dict()) == state
    assert state <= set(tm.initializers) and state <= set(jm.initializers)
    assert {n for n in tm.initializers if n in state} == \
        {n for n in jm.initializers if n in state}
    for name, t in tnet.state_dict().items():
        assert np.array_equal(tm.initializers[name], t.numpy()), name


def test_ernie_flash_fwd_is_lowered(tmp_path):
    """The trace holds K2's op (FLAGS_flash_attention_min_seq 128, S 128);
    the graph holds what its plain version computes."""
    jnet, tnet = _ernie_pair()
    _, tspecs = _ernie_specs()
    prev = tflags.get_flags("FLAGS_flash_attention_min_seq")
    tflags.set_flags({"FLAGS_flash_attention_min_seq": 128})
    try:
        ep, _ = EXPORT_MOD.trace(tnet, tspecs)
        flash = [n for n in ep.graph.nodes
                 if "flash_fwd" in str(n.target)]
        assert len(flash) == ERNIE_KW["num_hidden_layers"]
        path = export(tnet, str(tmp_path / "flash"), input_spec=tspecs)
        ids, mask = _ernie_feeds()
        with torch.no_grad():
            eager = tnet(torch.from_numpy(ids), torch.from_numpy(mask))
    finally:
        tflags.set_flags(prev)
    m = torch_onnx_eval.load(path)
    ops = m.op_types()
    assert ops.count("Softmax") == ERNIE_KW["num_hidden_layers"]
    assert all("flash" not in o.lower() for o in ops)
    got = m.run({"ids": ids, "mask": mask})[0]
    ref = jnet(paddle.to_tensor(ids.astype(np.int32)),
               paddle.to_tensor(mask.astype(np.int32))).numpy()
    _close(got, eager.numpy())
    _close(got, ref)


def test_flash_fwd_with_dropout_is_refused(tmp_path):
    class Drop(torch.nn.Module):
        def forward(self, q):
            return torch.ops.paddle_tpu_torch.flash_fwd(
                q, q, q, None, True, 0.125, 0.1, 7)[0]
    with pytest.raises(UnsupportedOnnxExport, match="dropout"):
        export(Drop(), str(tmp_path / "drop"),
               input_spec=[InputSpec([1, 2, 128, 64], "float32", "q")])


def test_causal_flash_fwd_lowering(tmp_path):
    class Causal(torch.nn.Module):
        def forward(self, q, k, v, bias):
            return torch.ops.paddle_tpu_torch.flash_fwd(
                q, k, v, bias, True, 0.2, 0.0, 0)[0]
    rng = np.random.RandomState(4)
    q, k, v = (rng.standard_normal((2, 2, 128, 32)).astype(np.float32)
               for _ in range(3))
    bias = np.where(rng.rand(2, 128) < 0.2, -1e4, 0.0).astype(np.float32)
    specs = [InputSpec(list(a.shape), "float32", n)
             for n, a in zip("qkvb", (q, k, v, bias))]
    path = export(Causal(), str(tmp_path / "causal"), input_spec=specs)
    got = torch_onnx_eval.run(path, dict(zip("qkvb", (q, k, v, bias))))[0]
    from paddle_tpu_torch.ops.flash_ops import _flash_fwd_reference
    ref = _flash_fwd_reference(*map(torch.from_numpy, (q, k, v, bias)),
                               True, 0.2)[0]
    _close(got, ref.numpy())


def test_jax_exporter_refuses_its_fused_qkv(tmp_path):
    """ROADMAP C42: the JAX exporter's table has no `split`, and its
    MultiHeadAttention splits a fused qkv product
    (`paddle_tpu/nn/layer/transformer.py:87`), so it refuses its ERNIE."""
    jnet, _ = _ernie_pair()
    jnet.eval()
    jspecs, _ = _ernie_specs()
    from paddle_tpu.onnx import UnsupportedOnnxExport as JUnsupported
    with pytest.raises(JUnsupported, match="split"):
        jexport(jnet, str(tmp_path / "jernie"), input_spec=jspecs)


# -- the ATen vocabulary ------------------------------------------------------------


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


_RNG = np.random.RandomState(30)
A = _RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
M = _RNG.standard_normal((4, 6)).astype(np.float32)
N = _RNG.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
Q = _RNG.standard_normal((2, 2, 8, 16)).astype(np.float32)
KPAD = np.where(_RNG.rand(2, 1, 8, 8) < 0.3, -1e4, 0.0).astype(np.float32)
I = _RNG.randint(0, 6, (4, 3)).astype(np.int64)
F_ = torch.nn.functional
VOCAB = {
    "gelu_tanh": (lambda x: F_.gelu(x, approximate="tanh"), [M]),
    "silu": (F_.silu, [M]),
    "leaky_relu": (lambda x: F_.leaky_relu(x, 0.2), [M]),
    "elu": (F_.elu, [M]),
    "hardsigmoid": (F_.hardsigmoid, [M]),
    "hardswish": (F_.hardswish, [M]),
    "relu6": (F_.relu6, [M]),
    "clamp": (lambda x: x.clamp(-0.5, 0.7) + x.clamp(min=0.1), [M]),
    "rsqrt_log1p_expm1": (lambda x: x.rsqrt() + x.log1p() + x.expm1(),
                          [N]),
    "unary": (lambda x: x.abs().neg().exp().sign() + x.floor() + x.ceil()
              + x.sin() + x.cos() + x.round() + x.reciprocal(), [N]),
    "arith": (lambda x, y: (x + 2 * y) * (x - y) / y + x ** 2
              + torch.maximum(x, y) - torch.minimum(x, y)
              + torch.pow(y, x) + torch.remainder(x, y)
              + torch.fmod(x, y) + torch.div(x, y, rounding_mode="floor")
              + torch.div(x, y, rounding_mode="trunc"), [M, N]),
    "compare_where": (lambda x, y: torch.where(
        (x > y) | (x <= 0.1) & ~(x == y) ^ (x != 0.3), x, y), [M, N]),
    "nan_inf": (lambda x: torch.isnan(x).float() + torch.isinf(x / 0.0)
                .float(), [M]),
    "cast": (lambda x: (x * 3).to(torch.int32).to(torch.float32), [M]),
    "slice_select": (lambda x: x[:, 1:5:2] + x[2:3, :3].sum()
                     + x[1].unsqueeze(0)[:, :3].mean(), [M]),
    "index_select_gather": (lambda x, i: torch.index_select(
        x, 1, i[:, 0]).sum(1, keepdim=True) + torch.gather(x, 1, i).sum(
        1, keepdim=True) + x[i[:, 1]].sum(), [M, I]),
    "flip_repeat_pad": (lambda x: F_.pad(x.flip(0), (1, 2)).repeat(2, 1)
                        .sum(), [M]),
    "reductions": (lambda x: x.sum(0) + x.mean(1).sum() + x.amax(1).sum()
                   + x.amin(0) + x.prod(1).sum()
                   + (x > 0).any(1).float().sum()
                   + (x > -5).all(0).float(), [M]),
    "max_argmax": (lambda x: x.max(1).values + x.argmax(1).float()
                   + x.argmin(1).float() + x.max() - x.min(), [M]),
    "cumsum_topk": (lambda x: x.cumsum(1).sum(1) + x.topk(2, 1).values
                    .sum(1), [M]),
    "log_softmax": (lambda x: F_.log_softmax(x, 1), [M]),
    "bmm_mm": (lambda x: torch.bmm(x[0], x[1].transpose(1, 2)).sum(0)
               @ x[0, 0], [Q]),
    "pools": (lambda x: F_.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
              .sum() + F_.adaptive_avg_pool2d(x, 2)
              + F_.adaptive_avg_pool2d(x, 1)
              + F_.max_pool2d(x, 2, 2, ceil_mode=False).sum(), [A]),
    "depthwise_conv": (lambda x: F_.conv2d(
        x, torch.ones(3, 1, 3, 3) * 0.1, stride=2, padding=1, groups=3),
        [A]),
    "library_sdpa": (lambda q, m: F_.scaled_dot_product_attention(
        q, q * 0.5, q, attn_mask=m), [Q, KPAD]),
    "library_sdpa_causal": (lambda q: F_.scaled_dot_product_attention(
        q, q, q * 2, is_causal=True), [Q]),
}


@pytest.mark.parametrize("case", sorted(VOCAB))
def test_op_vocabulary(tmp_path, case):
    """Each ATen form the exporter maps, in a small module: the graph
    evaluates to eager within the limit."""
    fn, xs = VOCAB[case]
    net = _Fn(fn)
    specs = [InputSpec(list(x.shape), str(x.dtype), f"x{i}")
             for i, x in enumerate(xs)]
    path = export(net, str(tmp_path / case), input_spec=specs)
    got = torch_onnx_eval.run(path, {f"x{i}": x for i, x in enumerate(xs)})
    with torch.no_grad():
        want = net(*[torch.from_numpy(x) for x in xs])
    _close(got[0], want.numpy())


def test_transposed_conv_is_refused(tmp_path):
    net = nn.Conv2DTranspose(3, 2, 3)
    with pytest.raises(UnsupportedOnnxExport, match="transposed"):
        export(net, str(tmp_path / "ct"),
               input_spec=[InputSpec([1, 3, 8, 8], "float32", "x")])
