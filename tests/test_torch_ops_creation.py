"""paddle_tpu_torch.ops.creation held to paddle_tpu.ops.creation, op by
op: every name of the reference module's `__all__` runs on the same
numpy inputs through both packages; the outputs' types are the JAX
package's (64-bit types off: `arange` of ints and the index ops int32,
float64 data float32, no `dtype` the default float32) and the values
equal (creation is exact). The port's default device is the card, so
the tests ask for the CPU (`set_device("cpu")`); with no card, a
creation op left on the default device raises UnavailableError."""
import numpy as np
import pytest
import torch

import paddle_tpu.ops.creation as jc
import paddle_tpu_torch as ptt
import paddle_tpu_torch.ops.creation as tc
from paddle_tpu_torch.framework.errors import UnavailableError
from torch_ops_parity import (compare, names_of, on_the_cpu,  # noqa: F401
                              r, ri, run_case)

X = r(0, 3, 4)
SQ = r(1, 4, 4)
V = r(2, 4)

CASES = {
    "to_tensor": (([[1.5, 2.0], [3.0, 4.0]],), {}),
    "to_tensor#ints": (([1, 2, 3],), {}),
    "to_tensor#dtype": (([1, 2, 3],), dict(dtype="float32")),
    "to_tensor#bool": (([True, False],), {}),
    "ones": (([2, 3],), {}),
    "ones#int": (([2, 3],), dict(dtype="int32")),
    "zeros": (([4],), dict(dtype="float32")),
    "full": (([2, 2], 1.5), {}),
    "full#int": (([2, 2], 3), {}),
    "full#dtype": (([3], 2), dict(dtype="float32")),
    "ones_like": ((X,), {}),
    "zeros_like": ((ri(3, 2, 3),), {}),
    "full_like": ((X, 0.25), {}),
    "full_like#dtype": ((X, 2), dict(dtype="int32")),
    "arange": ((5,), {}),
    "arange#start_end_step": ((2, 11, 3), {}),
    "arange#float": ((0.0, 1.0, 0.25), {}),
    "arange#dtype": ((4,), dict(dtype="float32")),
    "linspace": ((0.0, 1.0, 5), {}),
    "logspace": ((0.0, 2.0, 3), {}),
    "eye": ((3,), {}),
    "eye#rect": ((2, 4), {}),
    "empty": (([2, 3],), {}),
    "empty_like": ((X,), {}),
    "meshgrid": ((np.arange(3, dtype="float32"),
                  np.arange(2, dtype="float32")), {}),
    "diag": ((V,), {}),
    "diag#offset_pad": ((V,), dict(offset=1, padding_value=7.0)),
    "diag#matrix": ((SQ,), dict(offset=-1)),
    "diagflat": ((r(4, 2, 2),), dict(offset=1)),
    "tril": ((SQ,), {}),
    "tril#offset": ((SQ,), dict(diagonal=-1)),
    "triu": ((SQ,), dict(diagonal=1)),
    "assign": ((X,), {}),
    "clone": ((X,), {}),
    "numel": ((X,), {}),
    "tril_indices": ((4, 3, 0), {}),
    "triu_indices": ((3, 4, 1), {}),
    "vander": ((V,), {}),
    "vander#n_increasing": ((V,), dict(n=3, increasing=True)),
}


def test_every_reference_name_has_a_case():
    assert names_of(jc) == sorted(tc.__all__)
    assert set(names_of(jc)) == {n.split("#")[0] for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    run_case(jc, tc, name, CASES[name], 0)


@pytest.mark.parametrize("data", [np.arange(6.0).reshape(2, 3),
                                  np.arange(4, dtype=np.int64),
                                  np.array([1 + 2j], np.complex128)],
                         ids=["float64", "int64", "complex128"])
def test_to_tensor_of_numpy_takes_the_32_bit_type(data):
    """numpy data as it is (not a tensor of either package): 64-bit types
    come out in 32, as the JAX package gives them."""
    import paddle_tpu as paddle
    compare("to_tensor", tc.to_tensor(data), paddle.to_tensor(data), 0)


def test_to_tensor_place_and_stop_gradient():
    t = tc.to_tensor(X, place=ptt.CPUPlace(), stop_gradient=False)
    assert t.device.type == "cpu" and t.requires_grad and t.is_leaf
    src = torch.ones(2, requires_grad=True)
    u = tc.to_tensor(src)
    assert not u.requires_grad and u.dtype == torch.float32
    assert tc.to_tensor(src, dtype="int64").dtype == torch.int32


def test_assign_into_output():
    out = torch.zeros(3, 4)
    got = tc.assign(torch.from_numpy(X.copy()), out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), X)


def test_default_float_type():
    try:
        ptt.set_default_dtype("float16")
        assert ptt.get_default_dtype() == "float16"
        assert tc.zeros([2]).dtype == torch.float16
        assert tc.eye(2).dtype == torch.float16
    finally:
        ptt.set_default_dtype("float32")
    with pytest.raises(TypeError):
        ptt.set_default_dtype("int32")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    ptt.set_device("gpu")
    try:
        for fn in (lambda: tc.zeros([2]), lambda: tc.arange(3),
                   lambda: tc.to_tensor([1.0]), lambda: tc.eye(2)):
            with pytest.raises(UnavailableError):
                fn()
    finally:
        ptt.set_device("cpu")
