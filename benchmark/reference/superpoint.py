"""Plain PyTorch SuperPoint (gauss2 layout, arXiv:1712.07629 as in
eric-yyjau/pytorch-superpoint's ``SuperPointNet_gauss2``) in float32.

The encoder is four blocks of two conv3x3-BatchNorm-ReLU layers with a 2x2
max pool before blocks 2-4 (widths 64, 64, 128, 128); the detector head is
conv3x3 (256) then conv1x1 (65 logits), the descriptor head conv3x3 (256)
then conv1x1 (256), each conv followed by BatchNorm, the heads without ReLU
on their last layer.  BatchNorm uses its running statistics (inference).
The descriptor is L2-normalised over its channels.

Weights come from a flax-keyed npz (``params/<scope>/ConvBNRelu_<i>/Conv_0/
kernel`` and so on), read here with numpy.  Nothing of the program under
test is imported.  TF32 is switched off for every conv, so the products are
float32 products.

``quant``, when given, rounds each conv's input and kernel before the conv
(the benchmark's control computes the same network at a lower precision).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BLOCKS = ("inc", "down1", "down2", "down3")
HEADS = {"semi": ("convPa", "convPb"), "desc": ("convDa", "convDb")}

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def load_npz(path, device) -> Dict[str, torch.Tensor]:
    """The npz's leaves as float32 tensors on ``device``; conv kernels HWIO → OIHW."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key].astype(np.float32)
            if key.endswith("/kernel"):
                arr = arr.transpose(3, 2, 0, 1)
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def _cbr(w: Dict[str, torch.Tensor], scope: str, x: torch.Tensor, relu: bool,
         quant: Quant) -> torch.Tensor:
    kernel = w[f"params/{scope}/Conv_0/kernel"]
    if quant is not None:
        x, kernel = quant(x), quant(kernel)
    y = F.conv2d(x, kernel, w[f"params/{scope}/Conv_0/bias"], padding=kernel.shape[-1] // 2)
    y = F.batch_norm(y, w[f"batch_stats/{scope}/BatchNorm_0/mean"],
                     w[f"batch_stats/{scope}/BatchNorm_0/var"],
                     w[f"params/{scope}/BatchNorm_0/scale"], w[f"params/{scope}/BatchNorm_0/bias"],
                     training=False, eps=BN_EPS)
    return F.relu(y) if relu else y


def forward(w: Dict[str, torch.Tensor], images: torch.Tensor,
            quant: Quant = None) -> Dict[str, torch.Tensor]:
    """images [B, H, W] float32 in [0, 1] → ``semi`` [B, 65, H/8, W/8] logits and
    ``desc`` [B, 256, H/8, W/8] unit descriptors."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = images[:, None].float()
        for i, block in enumerate(BLOCKS):
            if i:
                x = F.max_pool2d(x, 2)
            for j in range(2):
                x = _cbr(w, f"{block}/ConvBNRelu_{j}", x, True, quant)
        out = {}
        for name, (a, b) in HEADS.items():
            out[name] = _cbr(w, b, _cbr(w, a, x, True, quant), False, quant)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out["desc"] = out["desc"] / (torch.linalg.vector_norm(out["desc"], dim=1, keepdim=True)
                                 + 1e-12)
    return out


def heatmap(semi: torch.Tensor) -> torch.Tensor:
    """Detector logits [B, 65, Hc, Wc] → keypoint probabilities [B, 8Hc, 8Wc]:
    softmax over the 65 channels, the 65th (no keypoint) dropped, channel
    ``8·dy + dx`` of a cell placed at its pixel (dy, dx)."""
    prob = torch.softmax(semi, dim=1)[:, :64]
    return F.pixel_shuffle(prob, 8)[:, 0]


def scaled_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude maps to 448), returned as float32: the precision step
    below bfloat16."""
    amax = t.abs().amax().clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale
