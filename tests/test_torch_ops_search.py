"""paddle_tpu_torch.ops.search held to paddle_tpu.ops.search, op by op:
every name of the reference module's `__all__` on the same numpy inputs
(free of ties, where the two libraries may pick another index) through
both packages. Index outputs are int32, the JAX package's type for the
reference's int64 with 64-bit types off; values equal."""
import numpy as np
import pytest

import paddle_tpu.ops.search as js
import paddle_tpu_torch.ops.search as ts
from torch_ops_parity import (names_of, on_the_cpu,  # noqa: F401
                              r, ri, run_case)

X = r(0, 3, 5)
X3 = r(1, 2, 3, 4)
SEQ = np.array([-1.0, 0.0, 0.5, 2.0, 3.0], "float32")
MODES = np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0], [7, 7, 7, 1, 2]],
                 "int32")

CASES = {
    "argmax": ((X,), {}),
    "argmax#axis": ((X3,), dict(axis=1, keepdim=True)),
    "argmax#keepdim_all": ((X,), dict(keepdim=True)),
    "argmax#dtype": ((X,), dict(axis=1, dtype="int32")),
    "argmin": ((X3,), dict(axis=-1)),
    "argmin#flat": ((X3,), {}),
    "argsort": ((X,), {}),
    "argsort#desc": ((X3,), dict(axis=1, descending=True)),
    "sort": ((X,), dict(axis=0)),
    "sort#desc": ((X3,), dict(descending=True)),
    "topk": ((X,), dict(k=2)),
    "topk#axis_smallest": ((X3,), dict(k=2, axis=1, largest=False)),
    "searchsorted": ((SEQ, np.array([[0.2, 2.0], [-3.0, 9.0]],
                                    "float32")), {}),
    "searchsorted#right": ((SEQ, np.array([0.0, 2.0, 2.5], "float32")),
                           dict(right=True)),
    "searchsorted#int32": ((SEQ, np.array([1.0], "float32")),
                           dict(out_int32=True)),
    "kthvalue": ((X,), dict(k=2)),
    "kthvalue#axis_keepdim": ((X3,), dict(k=3, axis=1, keepdim=True)),
    "mode": ((MODES,), {}),
    "mode#axis_keepdim": ((MODES,), dict(axis=0, keepdim=True)),
    "index_sample": ((X, ri(2, 3, 4, hi=5)), {}),
    "bucketize": ((np.array([[0.2, 2.0], [-3.0, 3.0]], "float32"), SEQ),
                  {}),
    "bucketize#right": ((np.array([0.0, 2.0], "float32"), SEQ),
                        dict(right=True)),
}


def test_every_reference_name_has_a_case():
    assert names_of(js) == sorted(ts.__all__)
    assert set(names_of(js)) == {n.split("#")[0] for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    run_case(js, ts, name, CASES[name], 0)
