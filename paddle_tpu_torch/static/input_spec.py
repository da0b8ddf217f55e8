"""InputSpec (port of `paddle_tpu.static.input_spec`; reference
`python/paddle/static/input.py`). `hapi.Model(net, inputs=[...])` reads
only how many there are: that many leading batch leaves feed the
network. `jit.save` reads shapes and types: `export_inputs` turns a list
of specs into `torch.export`'s example inputs and dynamic dims, as the
JAX package's `_spec_to_sds` turns them into symbolic shapes
(`paddle_tpu/jit/__init__.py:216-244`)."""
from __future__ import annotations

import torch

__all__ = ["InputSpec", "export_inputs", "EXAMPLE_BATCH"]

# the size a dynamic dim is traced at: torch specialises a dim whose
# example is 0 or 1 to that value, so a spec of batch None traced at 1
# would serve batch 1 only
EXAMPLE_BATCH = 2


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape),
                   str(tensor.dtype).replace("torch.", ""), name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)


def _dynamic(d) -> bool:
    return d is None or d == -1


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype).replace("torch.", ""), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"InputSpec: unknown dtype {dtype!r}")
    return dt


def export_inputs(specs, device="cpu"):
    """(example tensors, dynamic_shapes, dims) for `torch.export.export`
    from InputSpecs (or tensors, whose shapes are fixed).

    None/-1 dims stay dynamic: dim 0 of every input is one shared batch
    dim named "b" (every input's leading dim covaries, the serving
    engine's contract), every other dynamic dim gets a name of its own
    per input ("in<idx>_d<axis>"), so unrelated inputs are not
    constrained equal. Dynamic dims are traced at EXAMPLE_BATCH. `dims`
    is each input's dims as saved: ints, and the names of the dynamic
    ones."""
    batch = torch.export.Dim("b", min=1)
    examples, shapes, dims = [], [], []
    for idx, spec in enumerate(specs):
        if torch.is_tensor(spec):
            examples.append(spec.to(device))
            shapes.append(None)
            dims.append(tuple(int(d) for d in spec.shape))
            continue
        sizes, dyn, saved = [], {}, []
        for i, d in enumerate(spec.shape):
            if not _dynamic(d):
                sizes.append(int(d))
                saved.append(int(d))
            else:
                name = "b" if i == 0 else f"in{idx}_d{i}"
                dyn[i] = batch if i == 0 else torch.export.Dim(name, min=1)
                sizes.append(EXAMPLE_BATCH)
                saved.append(name)
        examples.append(torch.zeros(sizes, dtype=_torch_dtype(spec.dtype),
                                    device=device))
        shapes.append(dyn or None)
        dims.append(tuple(saved))
    return examples, shapes, dims
