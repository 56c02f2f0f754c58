"""Datasets and batch preparation (mirrors ``ssp/data``): image decoding
without OpenCV (``imageio``), the HPatches pairs, the KITTI/TUM/Apollo
sequences, COCO and ``Coco_sem``, the synthetic shapes drawn without OpenCV
(``synthetic_shapes``, ``raster``; registered under the ``dataset`` kind);
photometric augmentation and ``prepare_batch`` on the device."""

from ssp_torch.data import coco as _coco  # noqa: F401  (registers the dataset names)
from ssp_torch.data import hpatches as _hpatches  # noqa: F401
from ssp_torch.data import kitti as _kitti  # noqa: F401
from ssp_torch.data import synthetic_dataset as _synthetic  # noqa: F401
from ssp_torch.data.base import ImageDataset, read_gray  # noqa: F401
from ssp_torch.data.coco import CocoDataset, CocoSemDataset  # noqa: F401
from ssp_torch.data.hpatches import PatchesDataset  # noqa: F401
from ssp_torch.data.kitti import ApolloDataset, KittiDataset, TumDataset  # noqa: F401
from ssp_torch.data.synthetic_dataset import SyntheticShapesDataset  # noqa: F401
