"""Post-processing: heatmap → fixed-K keypoints + descriptors; matching."""

from ssp_torch.postprocess.nms import batched_nms, simple_nms, zero_border  # noqa: F401
from ssp_torch.postprocess.points import (  # noqa: F401
    extract_keypoints,
    sample_descriptors,
    soft_argmax_refine,
    top_k,
)
from ssp_torch.postprocess.tracker import PointTracker, nn_match_two_way  # noqa: F401
