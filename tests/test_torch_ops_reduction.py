"""paddle_tpu_torch.ops.reduction held to paddle_tpu.ops.reduction, op by
op: every name of the reference module's `__all__` on the same numpy
inputs through both packages, over every axis, one axis, a list of axes
and with keepdim. The outputs' types are the JAX package's (int32 sums
of int32 and bool inputs, float32 means of integers, an int32
count_nonzero) and the values within 1e-5 relative (the two libraries
sum in other orders). Under AMP's O1 `sum` and `mean` ("reduce_sum" /
"reduce_mean", the black list) cast a bfloat16 input up to float32 in
both packages, `max` does not."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.ops.reduction as jr
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.ops.reduction as tr
from torch_ops_parity import (compare, names_of, on_the_cpu,  # noqa: F401
                              r, ri, run_case)

X = r(0, 3, 4, 5)
A = ri(1, 3, 4, lo=-5, hi=6)
P = r(2, 3, 4) > 0
NANS = X.copy()
NANS[0, 1, 2] = NANS[2, 0, 0] = np.nan
TOL = 1e-5

CASES = {}
for _n in ("sum", "mean", "max", "min", "prod", "logsumexp", "std", "var",
           "amax", "amin", "nansum", "nanmean", "median", "nanmedian"):
    src = NANS if _n.startswith("nan") else X
    CASES[_n] = ((src,), {})
    CASES[_n + "#axis"] = ((src,), dict(axis=1))
    CASES[_n + "#axes_keepdim"] = ((src,), dict(axis=[0, 2], keepdim=True))
CASES.update({
    "sum#int": ((A,), dict(axis=0)),
    "sum#bool": ((P,), {}),
    "sum#dtype": ((A,), dict(dtype="float32")),
    "sum#keepdim_all": ((X,), dict(keepdim=True)),
    "mean#int": ((A,), {}),
    "prod#int": ((A,), dict(axis=1)),
    "all": ((P,), {}),
    "all#axis": ((P,), dict(axis=1, keepdim=True)),
    "any": ((P,), dict(axis=0)),
    "any#all": ((P,), {}),
    "std#biased": ((X,), dict(axis=2, unbiased=False)),
    "var#biased": ((X,), dict(axis=[1, 2], unbiased=False)),
    "count_nonzero": ((A,), {}),
    "count_nonzero#axis": ((A,), dict(axis=1, keepdim=True)),
    "nansum#int": ((A,), {}),
    "median#even": ((X[:, :4],), dict(axis=1)),
    "median#int": ((A,), dict(axis=1)),
    "quantile": ((X,), dict(q=0.3)),
    "quantile#axis": ((X,), dict(q=0.75, axis=2)),
    "quantile#list_keepdim": ((X,), dict(q=np.array([0.1, 0.5]), axis=[0, 1],
                                         keepdim=True)),
    "quantile#list_all_keepdim": ((X,), dict(q=np.array([0.25, 0.9]),
                                             keepdim=True)),
})


def test_every_reference_name_has_a_case():
    assert names_of(jr) == sorted(tr.__all__)
    assert set(names_of(jr)) == {n.split("#")[0] for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    run_case(jr, tr, name, CASES[name], TOL)


@pytest.mark.parametrize("name,want", [("sum", "float32"),
                                       ("mean", "float32"),
                                       ("logsumexp", "float32"),
                                       ("max", "bfloat16"),
                                       ("prod", "bfloat16")])
def test_amp_cast_by_op_name(name, want):
    with jamp.auto_cast(level="O1"):
        jo = getattr(jr, name)(paddle.to_tensor(X).astype("bfloat16"),
                               axis=1)
    with tamp.auto_cast(level="O1"):
        to = getattr(tr, name)(torch.from_numpy(X).to(torch.bfloat16),
                               axis=1)
    compare(name, to, jo, 2e-2)
    assert str(to.dtype) == f"torch.{want}"
