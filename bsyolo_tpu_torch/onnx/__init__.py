"""Self-contained ONNX export and runtime of the port (counterpart of ``bsyolo_tpu/onnx``).

Neither machine has the ``onnx`` or ``onnxruntime`` packages, so the format is written and read here
with no dependency beyond numpy and torch:

- ``proto``: a protobuf wire-format codec and the ONNX message schema (a copy of the JAX package's);
- ``builder``: an ONNX GraphProto/ModelProto builder (a copy of the JAX package's);
- ``lower``: lowers a ``torch.export`` program (core ATen and the port's ``bsyolo::`` operators) to an
  opset-13 graph, the port's own writer;
- ``runtime``: an independent numpy evaluator of the emitted op set (a copy of the JAX package's), the
  ``.onnx`` runtime of ``engine/backend.py AutoBackend``.
"""

from bsyolo_tpu_torch.onnx.lower import UnsupportedOp, export_onnx  # noqa: F401
from bsyolo_tpu_torch.onnx.runtime import OnnxModule  # noqa: F401
