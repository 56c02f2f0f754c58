"""Folded-BN bf16 inference forward for ``SuperPointGauss2``.

Port of ``ssp/models/fast_infer.py`` (and of ``fold_bn``,
``ssp/kernels/stem_pallas.py``).  Every inference BatchNorm folds into a
per-channel fp32 (scale, bias) epilogue, and the forward runs

  * the stem (inc: conv1a 1→64, conv1b 64→64 at full resolution, plus
    the first 2×2 max) through the CUDA kernel ``ssp_torch.kernels.stem``;
  * down1 (two 64→64 convs plus the second 2×2 max) through
    ``ssp_torch.kernels.down1``, at every batch size;
  * down2, down3 and the heads as folded convs: cuDNN bf16 convs on the
    card, fp32 convs of bf16 values on the CPU, each with the fp32
    epilogue in PyTorch.

Rounding points, as in the JAX path: the input is rounded to bf16, conv
weights are bf16, products accumulate in fp32, the scale/bias epilogue is
fp32, every activation between layers is stored bf16, and the semantic
1×1 conv takes a bf16 input with an fp32 accumulator plus bias.  One
difference on the card: cuDNN returns a bf16 conv output, so down2, down3
and the heads round the accumulator to bf16 once before their epilogue.

The TPU gates are not carried over: ``packed_stem_profitable`` (a
128-lane padding rule) and the B ≤ 4 down1 gate (measured on a v5e).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssp_torch._device import resolve_device
from ssp_torch.kernels.down1 import down1, down1_plain
from ssp_torch.kernels.stem import stem, stem_plain

Folded = Dict[str, Tuple[torch.Tensor, ...]]
_BLOCKS = {"inc": "inc.conv.conv", "d1": "down1.mpconv.1.conv",
           "d2": "down2.mpconv.1.conv", "d3": "down3.mpconv.1.conv"}
_HEADS = {"pa": ("convPa", "bnPa"), "pb": ("convPb", "bnPb"),
          "da": ("convDa", "bnDa"), "db": ("convDb", "bnDb"), "ds": ("convDS", "bnS1")}


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Inference BatchNorm → per-channel (scale, bias)."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def _fold_cbr(sd: Mapping[str, torch.Tensor], conv: str, bn: str):
    """One conv + BN pair → (kernel HWIO bf16, scale f32, bias f32) with
    the conv bias and BN affine folded into the epilogue."""
    s, b = fold_bn(sd[f"{bn}.weight"].float(), sd[f"{bn}.bias"].float(),
                   sd[f"{bn}.running_mean"].float(), sd[f"{bn}.running_var"].float())
    b = b + sd[f"{conv}.bias"].float() * s
    kernel = sd[f"{conv}.weight"].float().permute(2, 3, 1, 0).contiguous()  # OIHW → HWIO
    return kernel.to(torch.bfloat16), s, b


def fold_variables(variables: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Folded:
    """The port's model (or its reference-named state dict) → dict of
    folded inference weights.

    Keys: ``inc0/inc1`` (stem), ``d{1,2,3}a/b`` (trunk), ``pa/pb/da/db``
    (heads), optional ``ds/sout`` (semantic head).  Each value is
    ``(kernel HWIO bf16, scale f32, bias f32)`` except ``sout`` =
    ``(kernel HWIO bf16, bias f32)`` (plain conv, no BN).
    """
    sd = variables.state_dict() if isinstance(variables, nn.Module) else variables
    folded: Folded = {}
    for key, prefix in _BLOCKS.items():
        folded[f"{key}0" if key == "inc" else f"{key}a"] = _fold_cbr(sd, f"{prefix}.0", f"{prefix}.1")
        folded[f"{key}1" if key == "inc" else f"{key}b"] = _fold_cbr(sd, f"{prefix}.3", f"{prefix}.4")
    for key, (conv, bn) in _HEADS.items():
        if f"{conv}.weight" in sd:
            folded[key] = _fold_cbr(sd, conv, bn)
    if "convSout.weight" in sd:
        w = sd["convSout.weight"].float().permute(2, 3, 1, 0).contiguous()
        folded["sout"] = (w.to(torch.bfloat16), sd["convSout.bias"].float())
    return folded


def _to_device(folded: Folded, device: torch.device) -> Dict[str, Any]:
    """Folded weights on ``device``, with each torch-conv kernel also kept
    as an OIHW (channels-last on the card) tensor for ``F.conv2d``."""
    out: Dict[str, Any] = {}
    for key, vals in folded.items():
        vals = tuple(v.to(device) for v in vals)
        if key not in ("inc0", "inc1", "d1a", "d1b"):
            w = vals[0].permute(3, 2, 0, 1)
            if device.type == "cuda":
                w = w.contiguous(memory_format=torch.channels_last)
            else:
                w = w.float()
            vals = vals + (w,)
        out[key] = vals
    return out


def _conv(x: torch.Tensor, wsb, relu: bool = True) -> torch.Tensor:
    """Folded conv + BN (+ ReLU) on NHWC bf16 → NHWC bf16, fp32 epilogue."""
    _, s, b, w = wsb
    xin = x.permute(0, 3, 1, 2)
    if x.is_cuda:
        y = F.conv2d(xin, w, padding=w.shape[-1] // 2).float()
    else:
        y = F.conv2d(xin.float(), w, padding=w.shape[-1] // 2)
    y = y.permute(0, 2, 3, 1) * s + b
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16)


def _pool(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _forward(x: torch.Tensor, dev: Dict[str, Any], reference: bool) -> Dict[str, torch.Tensor]:
    """Folded-BN forward body.  ``reference=True`` runs the kernels'
    plain versions instead of the kernels (to check them on the card)."""
    stem_fn, down1_fn = (stem_plain, down1_plain) if reference else (stem, down1)
    t = stem_fn(x.float().contiguous(), *dev["inc0"][:3], *dev["inc1"][:3], pool=True)
    t = down1_fn(t, *dev["d1a"][:3], *dev["d1b"][:3], pool=True)
    t = _pool(_conv(_conv(t, dev["d2a"]), dev["d2b"]))
    feat = _conv(_conv(t, dev["d3a"]), dev["d3b"])

    semi = _conv(_conv(feat, dev["pa"]), dev["pb"], relu=False)
    desc = _conv(_conv(feat, dev["da"]), dev["db"], relu=False).float()
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)
    out = {"semi": semi.float(), "desc": desc}

    if "sout" in dev:
        cS = _conv(feat, dev["ds"])
        wS, bS = dev["sout"][:2]
        # 1×1 conv = matmul; bf16 values in fp32 with TF32 off on matmuls
        # (PyTorch's default): exact products, fp32 accumulation
        sem = cS.float() @ wS[0, 0].float() + bS
        Hc, Wc = sem.shape[1:3]
        sem = F.interpolate(sem.permute(0, 3, 1, 2), size=(Hc * 8, Wc * 8),
                            mode="bilinear", align_corners=False)
        out["sem"] = sem.permute(0, 2, 3, 1)
    return out


def make_fast_apply(
    variables: Union[nn.Module, Mapping[str, torch.Tensor]],
    *,
    device="cuda",
    reference: bool = False,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Build ``fn(images [B, H, W, 1]) → {"semi", "desc"[, "sem"]}``
    matching ``SuperPointGauss2.eval()(images)`` to bf16 rounding.

    Weights are folded once, here, and kept on ``device``.  H and W must
    be multiples of 8.  ``reference=True`` swaps every kernel for its
    plain PyTorch version (the card-side check of the kernels).
    """
    dev = _to_device(fold_variables(variables), resolve_device(device))

    @torch.inference_mode()
    def fast_apply(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(f"H and W must be multiples of 8, got {tuple(x.shape)}")
        return _forward(x, dev, reference)

    return fast_apply


def fast_apply_fn(variables: Union[nn.Module, Mapping[str, torch.Tensor]],
                  x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
    """One-shot form of :func:`make_fast_apply` on ``x``'s device (same
    ``(variables, x, train=False)`` signature as the JAX drop-in)."""
    if train:
        raise ValueError("fast_apply_fn is inference-only (train=False)")
    return make_fast_apply(variables, device=x.device)(x)
