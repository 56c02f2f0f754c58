"""Evaluation metrics (port of ``ssp/evaluations``): repeatability,
homography estimation, matching score, NN mAP, semantic segmentation.
Host-side numpy by design, as in the JAX package: this is the evaluation
protocol and keeps the reference's arithmetic
(``evaluations/detector_evaluation.py``, ``descriptor_evaluation.py``)."""

from ssp_torch.evaluations.descriptor import compute_homography  # noqa: F401
from ssp_torch.evaluations.detector import compute_repeatability  # noqa: F401
from ssp_torch.evaluations.semantic import evaluate_semantic  # noqa: F401
