"""Host-side datasets (mirrors ``ssp/data``): image decoding and the
HPatches pairs, registered under the ``dataset`` kind."""

from ssp_torch.data import hpatches as _hpatches  # noqa: F401  (registers the dataset names)
from ssp_torch.data.base import ImageDataset, read_gray  # noqa: F401
from ssp_torch.data.hpatches import PatchesDataset  # noqa: F401
