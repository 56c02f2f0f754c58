"""Geometry core: cell-grid ops, homographies, warping and valid masks."""

from ssp_torch.core.grid import (  # noqa: F401
    depth_to_space,
    flatten_detection,
    labels_to_cells,
    space_to_depth,
)
from ssp_torch.core.homography import (  # noqa: F401
    homography_from_corners,
    inv3,
    sample_homographies,
    sample_homography,
    scale_homography,
    warp_points,
)
from ssp_torch.core.warp import (  # noqa: F401
    bilinear_sample,
    compute_valid_mask,
    erode_mask,
    inv_warp_image,
    nearest_sample,
)
