"""paddle_tpu_torch.ops.logic held to paddle_tpu.ops.logic, op by op:
every name of the reference module's `__all__` on the same numpy inputs
through both packages, the outputs' types the JAX package's and the
values equal (comparisons are exact)."""
import numpy as np
import pytest
import torch

import paddle_tpu.ops.logic as jl
import paddle_tpu_torch.ops.logic as tl
from torch_ops_parity import (names_of, on_the_cpu,  # noqa: F401
                              r, ri, run_case)

X = r(0, 3, 4)
Y = X.copy()
Y[0, :2] += 1.0
A = ri(1, 3, 4, lo=-8, hi=8)
B = ri(2, 3, 4, lo=-8, hi=8)
P = X > 0
Q = Y > 0.5

CASES = {}
for _n in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"):
    CASES[_n] = ((X, Y), {})
    CASES[_n + "#int_scalar"] = ((A, 2), {})
for _n in ("logical_and", "logical_or", "logical_xor"):
    CASES[_n] = ((P, Q), {})
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    CASES[_n] = ((A, B), {})
    CASES[_n + "#bool"] = ((P, Q), {})
CASES.update({
    "logical_not": ((P,), {}),
    "bitwise_not": ((A,), {}),
    "bitwise_not#bool": ((P,), {}),
    "equal_all": ((X, X.copy()), {}),
    "equal_all#differs": ((X, Y), {}),
    "equal_all#shapes": ((X, X[:2]), {}),
    "allclose": ((X, X + 1e-7), {}),
    "allclose#not": ((X, Y), {}),
    "allclose#nan": ((np.array([np.nan, 1.0], "float32"),
                      np.array([np.nan, 1.0], "float32")),
                     dict(equal_nan=True)),
    "isclose": ((X, Y), dict(rtol=1e-3, atol=0.5)),
    "is_empty": ((X,), {}),
    "is_empty#empty": ((np.zeros((0, 3), "float32"),), {}),
})


def test_every_reference_name_has_a_case():
    assert names_of(jl) == sorted(tl.__all__)
    assert set(names_of(jl)) - {"is_tensor"} == {
        n.split("#")[0] for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    run_case(jl, tl, name, CASES[name], 0)


def test_is_tensor():
    import paddle_tpu as paddle
    assert jl.is_tensor(paddle.to_tensor(X)) and not jl.is_tensor(X)
    assert tl.is_tensor(torch.from_numpy(X)) and not tl.is_tensor(X)
