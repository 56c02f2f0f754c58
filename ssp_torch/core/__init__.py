"""Geometry core: cell-grid ops and bilinear sampling."""

from ssp_torch.core.grid import (  # noqa: F401
    depth_to_space,
    flatten_detection,
    labels_to_cells,
    space_to_depth,
)
from ssp_torch.core.warp import bilinear_sample  # noqa: F401
