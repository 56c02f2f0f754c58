"""Device-resident training corpus: upload once, sample on the device (port
of ``ssp/data/device_corpus.py``).

The whole training set lives in device memory: one upload at start-up,
then every batch is an index on the card drawn from the trainer's
generator, so steady-state training copies nothing from the host and
decodes nothing.  Sampling is uniform with replacement (the JAX package's
documented deviation from the reference's epoch reshuffle: the visit
distribution over an infinite stream is the same).

Images that are exact ``k/255`` grids (every decoded JPEG or PNG) are
stored as uint8, 4× smaller and exact after the sampler's ``/255``;
``quantize=True`` (``training.device_corpus_quantize``) rounds any image
to uint8 (≤ 1/510 absolute error).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ssp_torch._device import resolve_device


class DeviceCorpus:
    """All samples of a dataset as device tensors and a sampler.

    ``arrays`` holds ``image [N, H, W]`` (uint8, or float32 when the host
    images are not exact 255-grids), ``points [N, K, 2]``, ``points_valid
    [N, K]`` and, for ``Coco_sem``, ``sem [N, H, W]``: the keys of a host
    batch from ``ImageDataset.batches`` with N samples on the leading axis.
    """

    def __init__(self, arrays: Dict[str, torch.Tensor], n: int):
        self.arrays = arrays
        self.n = int(n)

    @classmethod
    def from_dataset(cls, dataset, *, device="cuda", max_bytes: int = 4 << 30,
                     quantize: bool = False) -> "DeviceCorpus":
        """Read every sample of ``dataset`` (an ``ImageDataset``) and upload.
        Raises ``ValueError`` when the corpus would take more than
        ``max_bytes``: the streaming loader is the way then."""
        dev = resolve_device(device)
        samples = [dataset[i] for i in range(len(dataset))]
        host = {k: np.stack([s[k] for s in samples]) for k in samples[0] if k != "name"}
        img = host["image"]
        q = np.round(img * 255.0)
        if quantize or np.allclose(q / 255.0, img, atol=1e-7):
            host["image"] = np.clip(q, 0.0, 255.0).astype(np.uint8)
        nbytes = sum(v.nbytes for v in host.values())
        if nbytes > max_bytes:
            raise ValueError(f"corpus is {nbytes / 1e9:.1f} GB > max_bytes "
                             f"{max_bytes / 1e9:.1f} GB; use the streaming loader")
        return cls({k: torch.from_numpy(v).to(dev) for k, v in host.items()}, len(samples))

    def sample(self, batch_size: int,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """A batch of ``batch_size`` rows drawn uniformly with replacement
        (indices from ``generator`` on the corpus's device); images as
        float32 in [0, 1]."""
        dev = self.arrays["image"].device
        idx = torch.randint(0, self.n, (batch_size,), generator=generator, device=dev)
        batch = {k: v[idx] for k, v in self.arrays.items()}
        if batch["image"].dtype == torch.uint8:
            batch["image"] = batch["image"].float() / 255.0
        return batch
