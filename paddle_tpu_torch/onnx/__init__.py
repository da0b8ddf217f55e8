"""paddle_tpu_torch.onnx — ONNX export with no external packages (port of
`paddle_tpu.onnx`).

The reference (`python/paddle/onnx/export.py`) delegates to the separate
paddle2onnx package. The port exports from its own trace: the layer's
`torch.export` program, decomposed to core ATen, with each ATen op mapped
to ONNX-13 ops; the protobuf wire format is written directly
(`wire.py` / `proto.py`), so the export works with neither `onnx` nor
`protobuf` installed.
"""
from __future__ import annotations

from .export import TorchToOnnx, UnsupportedOnnxExport, export

__all__ = ["export", "TorchToOnnx", "UnsupportedOnnxExport"]
