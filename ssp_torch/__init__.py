"""ssp_torch — Semantic SuperPoint in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of the JAX package ``ssp`` to PyTorch on an H100.  It mirrors
``ssp``'s layout and names (``ssp_torch.core.grid`` ↔ ``ssp.core.grid``,
``ssp_torch.kernels.nms`` ↔ ``ssp.kernels.nms_pallas``, …) and keeps its
NHWC layout at every public function, but never imports it: what it
needs from ``ssp`` it keeps as its own copy.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; there every kernel wrapper runs its plain PyTorch
version.  On a CUDA tensor a wrapper launches its kernel or raises.
"""

__version__ = "0.1.0"

from ssp_torch import registry  # noqa: F401
from ssp_torch import data as _data  # noqa: F401, E402  (registers the dataset names)
from ssp_torch import models as _models  # noqa: F401, E402  (registers the model names)
