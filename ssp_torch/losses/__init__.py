"""Training losses (mirrors ``ssp/losses``): the detector BCE, the sparse
descriptor hinge, the semantic CE at full and at 1/8 resolution, and the
Kendall multi-task weighting."""

from ssp_torch.losses.descriptor_dense import descriptor_loss_dense  # noqa: F401
from ssp_torch.losses.descriptor_sparse import descriptor_loss_sparse  # noqa: F401
from ssp_torch.losses.detector import detector_loss  # noqa: F401
from ssp_torch.losses.multitask import init_etas, multi_task_loss  # noqa: F401
from ssp_torch.losses.semantic import semantic_loss, semantic_loss_coarse  # noqa: F401
