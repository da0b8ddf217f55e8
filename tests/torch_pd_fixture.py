"""A reference-format (ProgramDesc protobuf + combined params) fixture
for the legacy `.pdmodel` import, written with Google's protobuf library
through dynamic descriptors that carry the reference's field numbers
(`paddle/fluid/framework/framework.proto:43-207`) — an encoder
independent of the hand-rolled wire parsers under test. The message
classes and the params framing are `tests/test_pd_import.py`'s, with the
OpAttr fields a transformer encoder needs (floats, bools).

`write_encoder(dir)` writes `pd_encoder.pdmodel` / `.pdiparams`: one
post-norm transformer-encoder layer (hidden 16, 2 heads of 8, FFN 32,
sequence 8, vocab 50) over token and position embeddings, pooled at
position 0 through a tanh head of 4, its weights drawn from a seed. The
committed copies under `tests/data/` are read by `chip_smoke.py` (the
card's machine has no protobuf package); `test_torch_pd_import.py`
re-encodes them and checks the bytes.

Run `python tests/torch_pd_fixture.py` to rewrite the committed copies.
"""
import os
import struct

import numpy as np

SEQ, HIDDEN, HEADS, FFN, VOCAB, CLASSES = 8, 16, 2, 32, 50, 4
HEAD_DIM = HIDDEN // HEADS
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NAME = "pd_encoder"


def make_classes():
    from google.protobuf import (descriptor_pb2, descriptor_pool,
                                 message_factory)
    f = descriptor_pb2.FileDescriptorProto()
    f.name = "pd_encoder_fixture.proto"
    f.package = "pdfix"
    f.syntax = "proto2"

    def msg(name):
        m = f.message_type.add()
        m.name = name
        return m

    def field(m, name, number, ftype, label=1, type_name=None):
        fd = m.field.add()
        fd.name = name
        fd.number = number
        fd.type = ftype
        fd.label = label  # 1 optional, 3 repeated
        if type_name:
            fd.type_name = type_name
        return fd

    T = descriptor_pb2.FieldDescriptorProto
    td = msg("TensorDesc")
    field(td, "data_type", 1, T.TYPE_INT32)
    field(td, "dims", 2, T.TYPE_INT64, label=3)
    lt = msg("LoDTensorDesc")
    field(lt, "tensor", 1, T.TYPE_MESSAGE, type_name=".pdfix.TensorDesc")
    field(lt, "lod_level", 2, T.TYPE_INT32)
    vt = msg("VarType")
    field(vt, "type", 1, T.TYPE_INT32)
    field(vt, "lod_tensor", 3, T.TYPE_MESSAGE,
          type_name=".pdfix.LoDTensorDesc")
    vd = msg("VarDesc")
    field(vd, "name", 1, T.TYPE_STRING)
    field(vd, "type", 2, T.TYPE_MESSAGE, type_name=".pdfix.VarType")
    field(vd, "persistable", 3, T.TYPE_BOOL)
    ov = msg("OpVar")
    field(ov, "parameter", 1, T.TYPE_STRING)
    field(ov, "arguments", 2, T.TYPE_STRING, label=3)
    oa = msg("OpAttr")
    field(oa, "name", 1, T.TYPE_STRING)
    field(oa, "type", 2, T.TYPE_INT32)
    field(oa, "i", 3, T.TYPE_INT32)
    field(oa, "f", 4, T.TYPE_FLOAT)
    field(oa, "ints", 6, T.TYPE_INT32, label=3)
    field(oa, "b", 10, T.TYPE_BOOL)
    od = msg("OpDesc")
    field(od, "inputs", 1, T.TYPE_MESSAGE, label=3,
          type_name=".pdfix.OpVar")
    field(od, "outputs", 2, T.TYPE_MESSAGE, label=3,
          type_name=".pdfix.OpVar")
    field(od, "type", 3, T.TYPE_STRING)
    field(od, "attrs", 4, T.TYPE_MESSAGE, label=3,
          type_name=".pdfix.OpAttr")
    bd = msg("BlockDesc")
    field(bd, "idx", 1, T.TYPE_INT32)
    field(bd, "parent_idx", 2, T.TYPE_INT32)
    field(bd, "vars", 3, T.TYPE_MESSAGE, label=3,
          type_name=".pdfix.VarDesc")
    field(bd, "ops", 4, T.TYPE_MESSAGE, label=3,
          type_name=".pdfix.OpDesc")
    pd = msg("ProgramDesc")
    field(pd, "blocks", 1, T.TYPE_MESSAGE, label=3,
          type_name=".pdfix.BlockDesc")

    pool = descriptor_pool.DescriptorPool()
    pool.Add(f)
    get = lambda n: message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"pdfix.{n}"))
    return {n: get(n) for n in ("TensorDesc", "LoDTensorDesc", "VarType",
                                "VarDesc", "OpVar", "OpAttr", "OpDesc",
                                "BlockDesc", "ProgramDesc")}


def params(seed=0):
    """The encoder's weights, float32, drawn from `seed`."""
    rs = np.random.RandomState(seed)

    def w(*shape, s=0.3):
        return (rs.standard_normal(shape) * s).astype(np.float32)
    p = {"word_emb": w(VOCAB, HIDDEN), "pos_emb": w(SEQ, HIDDEN)}
    for n in ("ln0", "ln1", "ln2"):
        p[f"{n}_scale"] = (1.0 + w(HIDDEN, s=0.1)).astype(np.float32)
        p[f"{n}_bias"] = w(HIDDEN, s=0.1)
    for n in ("wq", "wk", "wv", "wo"):
        p[n] = w(HIDDEN, HIDDEN)
        p["b" + n[1]] = w(HIDDEN, s=0.1)
    p["w1"], p["b1"] = w(HIDDEN, FFN), w(FFN, s=0.1)
    p["w2"], p["b2"] = w(FFN, HIDDEN), w(HIDDEN, s=0.1)
    p["wc"], p["bc"] = w(HIDDEN, CLASSES), w(CLASSES, s=0.1)
    return p


def build_encoder(C, prm):
    """ids, pos -> embeddings -> layer_norm -> one encoder layer (mul +
    elementwise_add(axis=2) projections, reshape2/transpose2 heads,
    matmul with transpose_Y and alpha, softmax, post-norm residuals, gelu
    FFN) -> slice of position 0 -> mul/add -> tanh."""
    prog = C["ProgramDesc"]()
    blk = prog.blocks.add()
    blk.idx = 0
    blk.parent_idx = -1

    def var(name, shape, persistable=False, vtype=7, dtype=5):
        v = blk.vars.add()
        v.name = name
        v.persistable = persistable
        v.type.type = vtype
        if shape is not None:
            v.type.lod_tensor.tensor.data_type = dtype
            v.type.lod_tensor.tensor.dims.extend(shape)

    def op(t, ins, outs, attrs=()):
        o = blk.ops.add()
        o.type = t
        for p, args in ins:
            v = o.inputs.add()
            v.parameter = p
            v.arguments.extend(args)
        for p, args in outs:
            v = o.outputs.add()
            v.parameter = p
            v.arguments.extend(args)
        for name, kind, val in attrs:
            at = o.attrs.add()
            at.name = name
            if kind == "i":
                at.type, at.i = 0, val
            elif kind == "f":
                at.type, at.f = 1, val
            elif kind == "ints":
                at.type = 3
                at.ints.extend(val)
            elif kind == "b":
                at.type, at.b = 6, val

    var("feed", None, vtype=9)
    var("fetch", None, vtype=10)
    var("ids", [-1, SEQ], dtype=3)
    var("pos", [-1, SEQ], dtype=3)
    for n, a in sorted(prm.items()):
        var(n, list(a.shape), persistable=True)
    n_tmp = [0]

    def tmp(shape):
        n_tmp[0] += 1
        name = f"t{n_tmp[0]}"
        var(name, shape)
        return name

    B3 = [-1, SEQ, HIDDEN]

    def dense(x, w, b, shape, ncol):
        y = tmp(shape)
        op("mul", [("X", [x]), ("Y", [w])], [("Out", [y])],
           [("x_num_col_dims", "i", ncol), ("y_num_col_dims", "i", 1)])
        z = tmp(shape)
        op("elementwise_add", [("X", [y]), ("Y", [b])], [("Out", [z])],
           [("axis", "i", ncol)])
        return z

    def norm(x, n):
        y = tmp(B3)
        op("layer_norm", [("X", [x]), ("Scale", [f"{n}_scale"]),
                          ("Bias", [f"{n}_bias"])], [("Y", [y])],
           [("begin_norm_axis", "i", 2), ("epsilon", "f", 1e-5)])
        return y

    def heads(x):
        r = tmp([-1, SEQ, HEADS, HEAD_DIM])
        op("reshape2", [("X", [x])], [("Out", [r])],
           [("shape", "ints", [0, SEQ, HEADS, HEAD_DIM])])
        t = tmp([-1, HEADS, SEQ, HEAD_DIM])
        op("transpose2", [("X", [r])], [("Out", [t])],
           [("axis", "ints", [0, 2, 1, 3])])
        return t

    op("feed", [("X", ["feed"])], [("Out", ["ids"])], [("col", "i", 0)])
    op("feed", [("X", ["feed"])], [("Out", ["pos"])], [("col", "i", 1)])
    e = tmp(B3)
    op("lookup_table_v2", [("W", ["word_emb"]), ("Ids", ["ids"])],
       [("Out", [e])], [("padding_idx", "i", -1)])
    p = tmp(B3)
    op("lookup_table_v2", [("W", ["pos_emb"]), ("Ids", ["pos"])],
       [("Out", [p])], [("padding_idx", "i", -1)])
    h = tmp(B3)
    op("elementwise_add", [("X", [e]), ("Y", [p])], [("Out", [h])],
       [("axis", "i", -1)])
    h = norm(h, "ln0")
    q, k, v = (heads(dense(h, f"w{c}", f"b{c}", B3, 2)) for c in "qkv")
    s = tmp([-1, HEADS, SEQ, SEQ])
    op("matmul", [("X", [q]), ("Y", [k])], [("Out", [s])],
       [("transpose_X", "b", False), ("transpose_Y", "b", True),
        ("alpha", "f", float(1.0 / np.sqrt(HEAD_DIM)))])
    a = tmp([-1, HEADS, SEQ, SEQ])
    op("softmax", [("X", [s])], [("Out", [a])], [("axis", "i", -1)])
    c = tmp([-1, HEADS, SEQ, HEAD_DIM])
    op("matmul", [("X", [a]), ("Y", [v])], [("Out", [c])],
       [("transpose_X", "b", False), ("transpose_Y", "b", False),
        ("alpha", "f", 1.0)])
    ct = tmp([-1, SEQ, HEADS, HEAD_DIM])
    op("transpose2", [("X", [c])], [("Out", [ct])],
       [("axis", "ints", [0, 2, 1, 3])])
    cm = tmp(B3)
    op("reshape2", [("X", [ct])], [("Out", [cm])],
       [("shape", "ints", [0, SEQ, HIDDEN])])
    o = dense(cm, "wo", "bo", B3, 2)
    r = tmp(B3)
    op("elementwise_add", [("X", [h]), ("Y", [o])], [("Out", [r])],
       [("axis", "i", -1)])
    h = norm(r, "ln1")
    f1 = dense(h, "w1", "b1", [-1, SEQ, FFN], 2)
    g = tmp([-1, SEQ, FFN])
    op("gelu", [("X", [f1])], [("Out", [g])], [("approximate", "b", False)])
    f2 = dense(g, "w2", "b2", B3, 2)
    r = tmp(B3)
    op("elementwise_add", [("X", [h]), ("Y", [f2])], [("Out", [r])],
       [("axis", "i", -1)])
    h = norm(r, "ln2")
    cls = tmp([-1, HIDDEN])
    op("slice", [("Input", [h]), ("X", [h])], [("Out", [cls])],
       [("axes", "ints", [1]), ("starts", "ints", [0]),
        ("ends", "ints", [1]), ("decrease_axis", "ints", [1])])
    lg = dense(cls, "wc", "bc", [-1, CLASSES], 1)
    out = tmp([-1, CLASSES])
    op("tanh", [("X", [lg])], [("Out", [out])])
    op("fetch", [("X", [out])], [("Out", ["fetch"])], [("col", "i", 0)])
    return prog


def combined_params(C, prm) -> bytes:
    """lod_tensor.cc:244 framing: u32 version, u64 lod_level(0), then
    tensor_util.cc TensorToStream: u32 version, i32 desc size, TensorDesc
    proto, raw data; sorted by name (fluid/io.py save order)."""
    out = []
    for name in sorted(prm):
        arr = prm[name]
        out.append(struct.pack("<I", 0) + struct.pack("<Q", 0)
                   + struct.pack("<I", 0))
        td = C["TensorDesc"]()
        td.data_type = 5
        td.dims.extend(arr.shape)
        blob = td.SerializeToString()
        out.append(struct.pack("<i", len(blob)) + blob)
        out.append(np.ascontiguousarray(arr, np.float32).tobytes())
    return b"".join(out)


def encode(seed=0):
    """(.pdmodel bytes, .pdiparams bytes) of the encoder fixture."""
    C = make_classes()
    prm = params(seed)
    return (build_encoder(C, prm).SerializeToString(),
            combined_params(C, prm))


def write_encoder(directory=DATA):
    model, prm = encode()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, NAME + ".pdmodel"), "wb") as f:
        f.write(model)
    with open(os.path.join(directory, NAME + ".pdiparams"), "wb") as f:
        f.write(prm)


def feeds(batch=3, seed=1):
    """(ids, pos) int64 feeds of the fixture."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, size=(batch, SEQ)).astype(np.int64)
    pos = np.tile(np.arange(SEQ, dtype=np.int64), (batch, 1))
    return ids, pos


if __name__ == "__main__":
    write_encoder()
