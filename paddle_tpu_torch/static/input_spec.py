"""InputSpec (port of `paddle_tpu.static.input_spec`; reference
`python/paddle/static/input.py`). `hapi.Model(net, inputs=[...])` reads
only how many there are: that many leading batch leaves feed the
network."""
from __future__ import annotations

__all__ = ["InputSpec"]


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
