"""`paddle_tpu_torch.utils.cpp_extension` held to
`paddle_tpu.utils.cpp_extension`: the same C source and the same inputs
through both packages give the same outputs and gradients
(`tests/test_static_and_extensions.py:80-117` are the reference's
tests). Also the port's own build contract (the ABI help on a failed
build, a rebuild only when a source changes) and K1 as a registered op,
`paddle_tpu_torch::paged_attention`, which the program store's exported
decode programs hold."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.utils import cpp_extension as jext
from paddle_tpu_torch.ops import paged_ops
from paddle_tpu_torch.utils import cpp_extension as ext

DOUBLE_OP = r"""
extern "C" void double_op(const float** ins, const long long** shapes,
                          const int* ndims, int n_in, float* out,
                          const long long* out_shape, int out_ndim) {
  long long total = 1;
  for (int i = 0; i < out_ndim; ++i) total *= out_shape[i];
  for (long long i = 0; i < total; ++i) out[i] = ins[0][i] * 2.0f;
}
extern "C" void double_op_grad(const float** ins, const long long** shapes,
                               const int* ndims, int n_in, float* out,
                               const long long* out_shape, int out_ndim) {
  long long total = 1;
  for (int i = 0; i < out_ndim; ++i) total *= out_shape[i];
  for (long long i = 0; i < total; ++i) out[i] = ins[0][i] * 2.0f;
}
"""

# out = a * b + a (two inputs); the gradient symbol gets [g, a, b] and
# yields d/da = g * (b + 1) only, as the reference's ABI has it
MUL_ADD_OP = r"""
extern "C" void mul_add(const float** ins, const long long** shapes,
                        const int* ndims, int n_in, float* out,
                        const long long* out_shape, int out_ndim) {
  long long total = 1;
  for (int i = 0; i < out_ndim; ++i) total *= out_shape[i];
  for (long long i = 0; i < total; ++i)
    out[i] = ins[0][i] * ins[1][i] + ins[0][i];
}
extern "C" void mul_add_grad(const float** ins, const long long** shapes,
                             const int* ndims, int n_in, float* out,
                             const long long* out_shape, int out_ndim) {
  long long total = 1;
  for (int i = 0; i < out_ndim; ++i) total *= out_shape[i];
  for (long long i = 0; i < total; ++i)
    out[i] = ins[0][i] * (ins[2][i] + 1.0f);
}
"""


def _src(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _jax_run(op, arrays):
    """Output and input gradients of sum(op(*arrays)) in the JAX
    package (its eager tape)."""
    xs = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    y = op(*xs)
    y.sum().backward()
    return y.numpy(), [x.grad.numpy() for x in xs]


def _port_run(op, arrays):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = op(*xs)
    y.sum().backward()
    return y.detach().numpy(), [x.grad.numpy() for x in xs]


def test_custom_cpp_op_matches_jax(tmp_path):
    src = _src(tmp_path, "myop.cc", DOUBLE_OP)
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    want, wgrads = _jax_run(jext.load("double_op", [src],
                                      grad_symbol="double_op_grad"), [x])
    op = ext.load("double_op", [src], grad_symbol="double_op_grad",
                  build_directory=str(tmp_path / "b"))
    got, grads = _port_run(op, [x])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(grads[0], wgrads[0])
    np.testing.assert_array_equal(got, x * 2)
    np.testing.assert_array_equal(grads[0], np.full_like(x, 2))


def test_custom_python_op_matches_jax():
    args = ("sq", lambda a: a ** 2, lambda s: s)
    bwd = dict(bwd=lambda g, a: (2 * a * g,))
    x = np.array([2.0, 3.0, -1.5], np.float32)
    want, wgrads = _jax_run(jext.load_op_from_callable(*args, **bwd), [x])
    got, grads = _port_run(ext.load_op_from_callable(*args, **bwd), [x])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(grads[0], wgrads[0])
    np.testing.assert_array_equal(grads[0], 2 * x)


def test_two_input_op_grad_abi_matches_jax(tmp_path):
    """The gradient symbol yields d/d input 0 only: the other inputs get
    zeros, in both packages."""
    src = _src(tmp_path, "muladd.cc", MUL_ADD_OP)
    rng = np.random.RandomState(1)
    a, b = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    want, wgrads = _jax_run(jext.load("mul_add", [src],
                                      grad_symbol="mul_add_grad"), [a, b])
    got, grads = _port_run(ext.load("mul_add", [src],
                                    grad_symbol="mul_add_grad",
                                    build_directory=str(tmp_path / "b")),
                           [a, b])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, a * b + a, rtol=1e-6)
    for g, w in zip(grads, wgrads):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(grads[1], np.zeros_like(b))


def test_op_without_grad_takes_no_gradient_and_keeps_device(tmp_path):
    src = _src(tmp_path, "myop.cc", DOUBLE_OP)
    op = ext.load("double_op", [src], build_directory=str(tmp_path / "b"),
                  out_shape_fn=lambda s: s)
    x = torch.ones(2, 2, requires_grad=True)
    y = op(x)
    assert not y.requires_grad and y.device == x.device
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(op(torch.arange(3)).numpy(), [0, 2, 4])


def test_build_error_carries_the_abi_help(tmp_path):
    src = _src(tmp_path, "bad.cc", "extern \"C\" void f( { }\n")
    with pytest.raises(RuntimeError) as e:
        ext.load("f", [src], build_directory=str(tmp_path / "b"))
    msg = str(e.value)
    assert "custom op build failed" in msg
    assert "const float** ins, const long long** shapes" in msg
    assert not [p for p in os.listdir(tmp_path / "b")
                if p.endswith((".so", ".tmp"))]


def test_rebuilds_only_when_a_source_changes(tmp_path):
    bdir = tmp_path / "b"
    src = _src(tmp_path, "myop.cc", DOUBLE_OP)
    ext.load("double_op", [src], build_directory=str(bdir))
    (so,) = [p for p in os.listdir(bdir) if p.endswith(".so")]
    mtime = os.path.getmtime(bdir / so)
    ext.load("double_op", [src], build_directory=str(bdir))
    assert os.listdir(bdir) == [so]
    assert os.path.getmtime(bdir / so) == mtime
    _src(tmp_path, "myop.cc", DOUBLE_OP.replace("2.0f", "3.0f"))
    op = ext.load("double_op", [src], build_directory=str(bdir))
    assert len([p for p in os.listdir(bdir) if p.endswith(".so")]) == 2
    np.testing.assert_array_equal(op(torch.ones(2)).numpy(), [3, 3])


def test_default_build_dir_is_the_ports_own(tmp_path):
    src = _src(tmp_path, "myop.cc", DOUBLE_OP)
    so = ext._compile([src])
    assert os.path.dirname(so) == str(ext._default_build_dir())
    assert "paddle_tpu_ext" not in so and "paddle_tpu_torch" in so


# -- K1 as a registered op ---------------------------------------------------

def _k1_inputs(seed=0, B=3, H=2, N=9, P=4, D=8, PP=3):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g)
    kp = torch.randn(H, N, P, D, generator=g)
    vp = torch.randn(H, N, P, D, generator=g)
    pt = torch.randint(0, N, (B, PP), generator=g, dtype=torch.int32)
    pos = torch.tensor([0, 5, 11], dtype=torch.int32)
    return q, kp, vp, pt, pos


def test_paged_attention_op_cpu_is_the_plain_version():
    q, kp, vp, pt, pos = _k1_inputs()
    want = paged_ops.paged_attention_plain(q, kp, vp, pt, pos, 0.35)
    got = torch.ops.paddle_tpu_torch.paged_attention(q, kp, vp, pt, pos,
                                                     0.35)
    assert torch.equal(got, want)
    assert torch.equal(paged_ops.paged_attention(q, kp, vp, pt, pos, 0.35),
                       want)
    assert paged_ops.paged_attention.launches == 0


class _Decode(torch.nn.Module):
    def forward(self, q, kp, vp, pt, pos):
        return paged_ops.paged_attention(q, kp, vp, pt, pos, 0.35) * 2.0


def test_paged_attention_op_exports_under_torch_export():
    """The op's fake implementation gives torch.export its shape, so an
    exported program holds the op (not the plain math) and runs it by the
    device of its inputs; saved and loaded, it gives the same values."""
    from paddle_tpu_torch import jit as pjit
    args = _k1_inputs()
    ep = torch.export.export(_Decode(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert "paddle_tpu_torch.paged_attention.default" in targets
    assert not any("einsum" in t or "softmax" in t for t in targets)
    loaded = pjit.deserialize_compiled(pjit.serialize_compiled(ep))
    want = paged_ops.paged_attention_plain(*args, 0.35) * 2.0
    assert torch.equal(loaded.module()(*args), want)
