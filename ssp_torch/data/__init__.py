"""Host-side datasets (mirrors ``ssp/data``): image decoding without
OpenCV (``imageio``), the HPatches pairs, the KITTI/TUM/Apollo sequences
and COCO, registered under the ``dataset`` kind."""

from ssp_torch.data import coco as _coco  # noqa: F401  (registers the dataset names)
from ssp_torch.data import hpatches as _hpatches  # noqa: F401
from ssp_torch.data import kitti as _kitti  # noqa: F401
from ssp_torch.data.base import ImageDataset, read_gray  # noqa: F401
from ssp_torch.data.coco import CocoDataset  # noqa: F401
from ssp_torch.data.hpatches import PatchesDataset  # noqa: F401
from ssp_torch.data.kitti import ApolloDataset, KittiDataset, TumDataset  # noqa: F401
