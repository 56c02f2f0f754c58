"""Model zoo — registry names match the reference's model strings."""

from ssp_torch.models.superpoint import SuperPointGauss2, build_model  # noqa: F401
