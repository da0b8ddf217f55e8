"""paddle_tpu_torch.ops.manipulation held to paddle_tpu.ops.manipulation,
op by op: every name of the reference module's `__all__` on the same
numpy inputs through both packages. Index inputs are int32 (the JAX
package's index type); the outputs' types are the JAX package's (index
outputs int32) and the values equal, except `tensordot`, a product
(1e-5 x max(1, max |ref|))."""
import numpy as np
import pytest
import torch

import paddle_tpu.ops.manipulation as jm
import paddle_tpu_torch.ops.manipulation as tm
from torch_ops_parity import (names_of, on_the_cpu,  # noqa: F401
                              r, ri, run_case)

X = r(0, 3, 4)
X3 = r(1, 2, 3, 4)
COL = r(2, 3, 1, 4)
IDX = np.array([2, 0, 1], "int32")
MASK = X > 0
CPLX = r(3, 3, 2)

CASES = {
    "reshape": ((X3,), dict(shape=[6, -1])),
    "flatten": ((X3,), dict(start_axis=1)),
    "transpose": ((X3,), dict(perm=[2, 0, 1])),
    "squeeze": ((COL,), dict(axis=1)),
    "squeeze#all": ((COL,), {}),
    "squeeze#not_one": ((COL,), dict(axis=[0, 1])),
    "unsqueeze": ((X,), dict(axis=[0, 2])),
    "concat": (([X, X * 2],), dict(axis=1)),
    "stack": (([X, X * 2],), dict(axis=0)),
    "split": ((X3,), dict(num_or_sections=2, axis=2)),
    "split#sections": ((X3,), dict(num_or_sections=[1, -1], axis=2)),
    "chunk": ((X3,), dict(chunks=3, axis=1)),
    "tile": ((X,), dict(repeat_times=[2, 1])),
    "expand": ((COL,), dict(shape=[2, 3, 5, -1])),
    "expand_as": ((COL, np.zeros((3, 6, 4), "float32")), {}),
    "broadcast_to": ((COL,), dict(shape=[3, 2, 4])),
    "gather": ((X, IDX), {}),
    "gather#axis": ((X, IDX), dict(axis=1)),
    "gather_nd": ((X3, np.array([[0, 1], [1, 2]], "int32")), {}),
    "scatter": ((X, np.array([2, 0], "int32"), r(4, 2, 4)), {}),
    "scatter#add": ((X, np.array([2, 2, 0], "int32"), r(4, 3, 4)),
                    dict(overwrite=False)),
    "scatter_nd_add": ((X, np.array([[0, 1], [2, 3], [0, 1]], "int32"),
                        r(5, 3)), {}),
    "index_select": ((X, IDX), dict(axis=0)),
    "masked_select": ((X, MASK), {}),
    "where": ((MASK, X, -X), {}),
    "where#nonzero": ((MASK,), {}),
    "roll": ((X,), dict(shifts=1, axis=1)),
    "roll#flat": ((X,), dict(shifts=5)),
    "flip": ((X3,), dict(axis=[0, 2])),
    "flip#int": ((X,), dict(axis=1)),
    "cast": ((X,), dict(dtype="int32")),
    "cast#int64": ((X,), dict(dtype="int64")),
    "t": ((X,), {}),
    "moveaxis": ((X3, 0, 2), {}),
    "unbind": ((X,), dict(axis=1)),
    "repeat_interleave": ((X,), dict(repeats=2, axis=0)),
    "repeat_interleave#flat": ((X,), dict(repeats=2)),
    "take_along_axis": ((X, ri(6, 3, 2, hi=4)), dict(axis=1)),
    "put_along_axis": ((X, np.array([[1], [0], [3]], "int32"), 9.0),
                       dict(axis=1)),
    "put_along_axis#add": ((X, np.array([[1, 2], [0, 0], [3, 1]], "int32"),
                            r(7, 3, 2)), dict(axis=1, reduce="add")),
    "put_along_axis#mul": ((X, np.array([[1], [0], [3]], "int32"), 2.0),
                           dict(axis=1, reduce="mul")),
    "slice": ((X3,), dict(axes=[1, 2], starts=[1, 0], ends=[3, -1])),
    "strided_slice": ((X3,), dict(axes=[2], starts=[0], ends=[4],
                                  strides=[2])),
    "strided_slice#reverse": ((X3,), dict(axes=[1, 2], starts=[2, 3],
                                          ends=[-4, 0], strides=[-1, -2])),
    "unique": ((np.array([3, 1, 2, 3, 1], "int32"),), {}),
    "unique#all": ((np.array([3, 1, 2, 3, 1], "int32"),),
                   dict(return_index=True, return_inverse=True,
                        return_counts=True)),
    "nonzero": ((MASK,), {}),
    "nonzero#tuple": ((MASK,), dict(as_tuple=True)),
    "pad": ((X3,), dict(pad=[1, 2], value=0.5)),
    "pad#all_axes": ((X,), dict(pad=[1, 0, 0, 2])),
    "pad#reflect": ((X3,), dict(pad=[2, 1], mode="reflect")),
    "pad#replicate": ((X3,), dict(pad=[1, 2, 2, 1], mode="replicate")),
    "pad#circular": ((X3,), dict(pad=[3, 1], mode="circular")),
    "pad#nhwc": ((X3,), dict(pad=[1, 1], data_format="NLC")),
    "rot90": ((X,), dict(k=1)),
    "rot90#axes": ((X3,), dict(k=3, axes=(1, 2))),
    "unstack": ((X,), dict(axis=0)),
    "crop": ((X3,), dict(shape=[1, 2, 2], offsets=[1, 1, 1])),
    "shard_index": ((ri(8, 6, 1, hi=20),), dict(index_num=20, nshards=4,
                                                 shard_id=1)),
    "broadcast_tensors": (([COL, X[None, :, None, :].reshape(1, 3, 1, 4)
                            .repeat(2, 0)],), {}),
    "atleast_1d": ((np.array(3.0, "float32"),), {}),
    "as_real": ((X.astype("complex64") * (1 + 2j),), {}),
    "as_complex": ((CPLX,), {}),
    "tensordot": ((X3, r(9, 4, 3)), dict(axes=1)),
    "tensordot#pairs": ((X3, r(10, 3, 2, 5)), dict(axes=[[0, 1], [1, 0]])),
    "masked_fill": ((X, MASK, -1.0), {}),
    "index_put": ((X, [np.array([0, 2], "int32"),
                       np.array([1, 3], "int32")], np.array([5.0, 6.0],
                                                            "float32")),
                  {}),
    "index_put#accumulate": ((X, [np.array([0, 0], "int32")],
                              r(11, 2, 4)), dict(accumulate=True)),
    "index_add": ((X, np.array([0, 2, 0], "int32"), 1, r(12, 3, 3)), {}),
    "diagonal": ((X3,), dict(offset=1, axis1=1, axis2=2)),
    "one_hot": ((np.array([0, 2, 5, -1], "int32"),), dict(num_classes=4)),
    "index_fill": ((X, np.array([1, 3], "int32"), 1, 0.5), {}),
    "diagonal_scatter": ((X, r(13, 3)), {}),
    "diagonal_scatter#offset": ((X3, r(14, 2, 3)),
                                dict(offset=1, axis1=1, axis2=2)),
}
TOL = {"tensordot": 1e-5}


def test_every_reference_name_has_a_case():
    assert names_of(jm) == sorted(tm.__all__)
    assert set(names_of(jm)) == {n.split("#")[0] for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    run_case(jm, tm, name, CASES[name], TOL.get(name.split("#")[0], 0))


def test_gradients_flow_through_the_index_ops():
    """The index casts are internal: a float input keeps its gradient."""
    x = torch.from_numpy(X.copy()).requires_grad_()
    i = torch.tensor([2, 0], dtype=torch.int32)
    out = tm.gather(x, i).sum() + tm.take_along_axis(
        x, torch.tensor([[1], [0], [3]], dtype=torch.int32), 1).sum()
    out.backward()
    want = np.zeros_like(X)
    want[[2, 0]] += 1
    want[[0, 1, 2], [1, 0, 3]] += 1
    np.testing.assert_array_equal(x.grad.numpy(), want)
