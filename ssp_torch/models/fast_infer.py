"""Folded-BN bf16 inference forward for ``SuperPointGauss2``.

Port of ``ssp/models/fast_infer.py`` (and of ``fold_bn``,
``ssp/kernels/stem_pallas.py``).  Every inference BatchNorm folds into a
per-channel fp32 (scale, bias) epilogue, and the forward runs

  * the stem (inc: conv1a 1→64, conv1b 64→64 at full resolution, plus
    the first 2×2 max) through the CUDA kernel ``ssp_torch.kernels.stem``;
  * down1 (two 64→64 convs plus the second 2×2 max) through
    ``ssp_torch.kernels.down1``, at every batch size;
  * down2, down3 and the heads as folded convs of the bf16 values held in
    fp32 (:func:`_conv`), each with the fp32 epilogue in PyTorch.

Rounding points, as in the JAX path: the input is rounded to bf16, conv
weights are bf16, products accumulate in fp32, the scale/bias epilogue is
fp32 and reads the fp32 accumulator unrounded, every activation between
layers is stored bf16, and the semantic 1×1 conv takes a bf16 input with
an fp32 accumulator plus bias.

The TPU gates are not carried over: ``packed_stem_profitable`` (a
128-lane padding rule) and the B ≤ 4 down1 gate (measured on a v5e).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssp_torch._device import resolve_device
from ssp_torch.kernels.down1 import down1_plain, down1_prepared, prepare_down1
from ssp_torch.kernels.stem import prepare_stem, stem_plain, stem_prepared

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
    """Folded weights on ``device``, each laid out once for what runs it:
    ``stem`` and ``down1`` as the kernels' prepared pairs, every other conv
    with its kernel also kept as an fp32 OIHW (channels-last on the card)
    tensor for ``F.conv2d``."""
    out: Dict[str, Any] = {}
    on_dev = {key: tuple(v.to(device) for v in vals) for key, vals in folded.items()}
    out["stem"] = prepare_stem(*on_dev.pop("inc0"), *on_dev.pop("inc1"))
    out["down1"] = prepare_down1(*on_dev.pop("d1a"), *on_dev.pop("d1b"))
    for key, vals in on_dev.items():
        w = vals[0].float().permute(3, 2, 0, 1)
        if device.type == "cuda":
            w = w.contiguous(memory_format=torch.channels_last)
        out[key] = vals + (w,)
    return out


def _conv_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC bf16 activation, fp32 OIHW kernel of bf16 values → the conv's
    fp32 accumulator, NHWC (a view), unrounded.

    The conv is an fp32 ``F.conv2d`` of the bf16 values.  On the card cuDNN's
    TF32 path is switched ON for the call (and restored after): a bf16 value
    (8-bit exponent, 7-bit mantissa) is exactly representable in TF32 (8-bit
    exponent, 10-bit mantissa), so the tensor cores multiply these operands
    exactly, accumulate in fp32 and return the fp32 accumulator.  A bf16
    ``F.conv2d`` would return that accumulator rounded to bf16."""
    xin = x.permute(0, 3, 1, 2).float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = F.conv2d(xin, w, padding=w.shape[-1] // 2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, wsb, relu: bool = True) -> torch.Tensor:
    """Folded conv + BN (+ ReLU) on NHWC bf16 → NHWC bf16: bf16 operands,
    fp32 accumulator (:func:`_conv_acc`), fp32 epilogue on the unrounded
    accumulator."""
    _, s, b, w = wsb
    y = _conv_acc(x, w) * s + b
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16)


def accumulator_errors(variables: Union[nn.Module, Mapping[str, torch.Tensor]], image_shape,
                       *, device="cuda", seed: int = 0) -> Dict[str, float]:
    """How far each folded conv's accumulator (:func:`_conv_acc`) is from an
    fp32 conv with TF32 off, for the convs of down2, down3 and the heads at
    the activation shapes an ``image_shape = (B, H, W)`` batch gives them, on
    seeded bf16-valued inputs: ``{layer: max|got − want| / max|want|}``.

    Exact products summed in fp32 in two orders differ by a few 2⁻²⁴ of the
    sum of magnitudes; an accumulator that was rounded to bf16 is off by
    2⁻⁹ of the value.  The callers hold the result under 2⁻¹⁴.
    """
    dev = resolve_device(device)
    weights = _to_device(fold_variables(variables), dev)
    B, H, W = image_shape
    gen = torch.Generator().manual_seed(seed)
    errors: Dict[str, float] = {}
    for key, div in (("d2a", 4), ("d2b", 4), ("d3a", 8), ("d3b", 8), ("pa", 8), ("pb", 8),
                     ("da", 8), ("db", 8), ("ds", 8)):
        if key not in weights:
            continue
        w = weights[key][3]
        x = torch.rand((B, H // div, W // div, w.shape[1]), generator=gen).to(dev, torch.bfloat16)
        got = _conv_acc(x, w)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            want = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=w.shape[-1] // 2)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        want = want.permute(0, 2, 3, 1)
        errors[key] = float((got - want).abs().max() / want.abs().max())
    return errors


def _pool(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _forward(x: torch.Tensor, dev: Dict[str, Any], reference: bool) -> Dict[str, torch.Tensor]:
    """Folded-BN forward body.  ``reference=True`` runs the kernels'
    plain versions instead of the kernels (to check them on the card)."""
    x = x.float().contiguous()
    if reference:
        t = down1_plain(stem_plain(x, *dev["stem"].params), *dev["down1"].params)
    else:
        t = down1_prepared(stem_prepared(x, dev["stem"]), dev["down1"])
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


def supports_fast(variables: Union[nn.Module, Mapping[str, torch.Tensor]]) -> bool:
    """True when ``variables`` (the port's model or a reference-named state
    dict) has the SuperPointGauss2 layout with BatchNorm statistics: the
    layout :func:`fold_variables` understands."""
    sd = variables.state_dict() if isinstance(variables, nn.Module) else variables
    return "inc.conv.conv.0.weight" in sd and "inc.conv.conv.1.running_mean" in sd


def best_apply_fn(model: nn.Module, input_hw: Optional[Tuple[int, int]] = None,
                  enable: bool = True, *, device="cuda") -> Callable:
    """The fastest forward for ``model`` as ``fn(images [B, H, W, 1]) →
    {"semi", "desc"[, "sem"]}`` on ``device``: the folded bf16 forward
    (:func:`make_fast_apply`) when the model supports BN folding, else the
    fp32 module itself.

    ``enable=False`` always returns the fp32 module: the reproducibility
    opt-out for exports that must not shift with the bf16 path (keypoint-set
    agreement between the two is about 90%, not exact).

    The JAX package also gates on ``input_hw`` (``packed_stem_profitable``,
    a 128-lane padding rule of the TPU stem).  On an H100 the folded forward
    was timed against the fp32 module at the export's 100×240×320 and at the
    main path's 16×480×640 and won at both (PERF.md), so ``input_hw`` is
    accepted for the callers that pass it and decides nothing.
    """
    dev = resolve_device(device)
    if enable and supports_fast(model):
        return make_fast_apply(model, device=dev)
    return model.to(dev).eval()


def fast_apply_fn(variables: Union[nn.Module, Mapping[str, torch.Tensor]],
                  x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
    """One-shot form of :func:`make_fast_apply` on ``x``'s device (same
    ``(variables, x, train=False)`` signature as the JAX drop-in)."""
    if train:
        raise ValueError("fast_apply_fn is inference-only (train=False)")
    return make_fast_apply(variables, device=x.device)(x)
