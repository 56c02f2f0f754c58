"""Export pipelines of the port (mirrors ``ssp/export``)."""

from ssp_torch.export.descriptors_export import make_detect_describe_fn, run_descriptor_export
from ssp_torch.export.homography_adaptation import DEFAULT_HA, make_ha_fn, run_ha_export

__all__ = ["DEFAULT_HA", "make_detect_describe_fn", "make_ha_fn", "run_descriptor_export",
           "run_ha_export"]
