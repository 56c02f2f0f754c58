"""Fused SuperPoint stem: conv3×3 1→64 → folded BN → ReLU → conv3×3 64→64
→ folded BN → ReLU (→ 2×2 max), NHWC, SAME padding.

Replaces two TPU kernels with the CUDA kernel ``ssp_torch/csrc/stem.cu``:
``ssp/kernels/stem_pallas_v2.py::stem_pallas_packed`` (the stem with the
pool fused, ``pool=True``: ``stem_kernel<true>``) and
``ssp/kernels/stem_pallas.py::stem_pallas`` (the first stem kernel, without
the pool, ``pool=False``: ``stem_kernel<false>``; no path of either package
runs it).

What bounds it on an H100: tensor-core operations.  At 480×640×16 the
second conv is ~0.36 TFLOP of bf16 work (~0.37 ms at 989 TFLOP/s) against
~0.18 GB of HBM traffic (~0.05 ms).  The kernel keeps the 64-channel
full-resolution intermediate in shared memory, never in device memory;
persistent blocks, one per SM, hold both convs' weights in shared memory
for all their tiles; three warpgroups each walk over their own tiles, so
that one's loads, first conv and epilogue run beside another's main loop;
both convs are implicit GEMMs on ``wgmma`` with fp32 accumulation; the 2×2
max is fused into the epilogue, so the kernel writes a quarter of the
pixels.  The TPU kernel's x-pair 128-lane packing answered the TPU's lane
width and has no counterpart here.

The kernel reads both convs' weights as the exact images of its shared
memory (:func:`swizzle_w1`, :func:`swizzle_w2`); :func:`prepare_stem` builds
them once, where the weights go to the device, and :func:`stem_prepared`
launches with them.  :func:`stem` takes HWIO weights and prepares them per
call.

Numerics (the TPU kernel's rounding points): the input is rounded to
bf16, weights are bf16, products accumulate in fp32, scale/bias/ReLU are
fp32, the intermediate is rounded to bf16 before the second conv, and
the output is bf16.  :func:`stem_plain` computes the same function in
PyTorch and is what :func:`stem` runs for a CPU tensor.

``launches`` counts the kernel launches of :func:`stem` and
:func:`stem_prepared`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ssp_torch.kernels import _build

C = 64
launches = 0


# How far the stem and down1 kernels may sit from their plain versions (or
# from the Pallas kernels): elementwise |got − want| ≤ 2⁻⁷·|want| +
# 2⁻⁸·max|want|, with at most 1% of the elements differing at all.
# * 2⁻⁷·|want|, two bf16 ulps of the value: the output is bf16, and an fp32
#   sum taken in another order can flip its rounding.
# * 2⁻⁸·max|want|: a flipped rounding of the bf16 intermediate moves the
#   second conv's sum by one ulp of that intermediate times its weight,
#   which is a share of the output's overall magnitude, not of an output
#   that cancelled to near zero (on an H100 such moves reached about
#   2⁻¹⁰·max|want| with random weights).  A wrong tap, halo or channel
#   moves outputs by their own size and fails both bars.
# * The 1% share: tensor cores do not add fp32 products in IEEE order, so
#   the kernels flip some bf16 roundings even against an fp64 reference
#   with the same rounding points (tests/test_torch_cuda.py holds them to
#   these bars against fp64 too).
RTOL, ATOL_OF_MAX, MAX_DIFFERING = 2.0 ** -7, 2.0 ** -8, 1e-2

def assert_bf16_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise AssertionError unless ``got`` is within the bars above of
    ``want``; returns the max abs difference."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bound = RTOL * want.abs() + ATOL_OF_MAX * want.abs().max()
    max_err = float(err.max()) if err.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"outside the bf16 bars: max abs err {max_err}, "
                             f"{int((err > bound).sum())} elements over")
    differing = float((err > 0).float().mean())
    if differing > MAX_DIFFERING:
        raise AssertionError(f"{differing:.2e} of the elements differ (> {MAX_DIFFERING})")
    return max_err


def _conv_affine_relu(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """NCHW fp32 holding bf16 values, HWIO bf16 weights → fp32 NCHW
    ``max(conv·s + b, 0)``.  The products of bf16 values are exact in fp32,
    so only the summation order can differ from the kernel; cuDNN's TF32
    path is switched off for the call, as it sums less exactly than fp32."""
    wt = w.float().permute(3, 2, 0, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x, wt, padding=w.shape[0] // 2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return torch.relu(y * s[:, None, None] + b[:, None, None])


def conv_pair_plain(x: torch.Tensor, w1, s1, b1, w2, s2, b2, pool: bool) -> torch.Tensor:
    """Plain version shared by the stem and down1: x NHWC (bf16 values)."""
    h = x.float().permute(0, 3, 1, 2)
    h = _conv_affine_relu(h, w1, s1, b1).to(torch.bfloat16).float()
    h = _conv_affine_relu(h, w2, s2, b2)
    if pool:
        h = F.max_pool2d(h, 2)
    return h.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _check_affine(cin: int, w1, s1, b1, w2, s2, b2) -> None:
    for name, w, shape in (("w1", w1, (3, 3, cin, C)), ("w2", w2, (3, 3, C, C))):
        if tuple(w.shape) != shape or w.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 {shape}, got {w.dtype} {tuple(w.shape)}")
    for name, v in (("scale1", s1), ("bias1", b1), ("scale2", s2), ("bias2", b2)):
        if tuple(v.shape) != (C,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({C},), got {v.dtype} {tuple(v.shape)}")


class PreparedPair(NamedTuple):
    """A conv pair's weights, checked once and ready for its kernel."""

    params: Tuple[torch.Tensor, ...]  # (w1, s1, b1, w2, s2, b2) as given: HWIO bf16, fp32 [64]
    kernel: Tuple[torch.Tensor, ...]  # the same six, contiguous, in the CUDA kernel's layouts


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, in, out]`` → ``[3, 3, out, in]``, input channels
    contiguous: the order that :func:`swizzle_w2` swizzles."""
    return w.permute(0, 1, 3, 2).contiguous()


def _xor_chunks(w: torch.Tensor) -> torch.Tensor:
    """``[taps, 64, 8, 8]`` (tap, row, 16-byte chunk, element) → the same with
    chunk ``c`` of row ``n`` at position ``c ^ (n & 7)``: the 128-byte
    swizzle.  It is its own inverse."""
    n = torch.arange(C, device=w.device)[:, None]
    pos = torch.arange(8, device=w.device)[None, :]
    src = (pos ^ (n & 7))[None, :, :, None].expand_as(w)
    return torch.gather(w, 2, src)


def swizzle_w2(w2: torch.Tensor) -> torch.Tensor:
    """A 64→64 conv's HWIO bf16 weights ``[3, 3, 64, 64]`` (the stem's
    second conv, either of down1's) → the flat image ``[9·64·64]`` that
    ``stem.cu`` and ``down1.cu`` copy into shared memory as it is:
    element (tap, out ``n``, in ``k``) at byte
    ``tap·8192 + n·128 + (((k >> 3) ^ (n & 7)) << 4) + (k & 7)·2``, the
    K-major 128-byte-swizzle layout that a ``wgmma`` descriptor reads."""
    return _xor_chunks(kernel_layout(w2).reshape(9, C, 8, 8)).reshape(-1)


def swizzle_w1(w1: torch.Tensor) -> torch.Tensor:
    """The first conv's HWIO bf16 weights ``[3, 3, 1, 64]`` → one more
    8,192-byte slice of the same layout, flat ``[64·64]``: row ``n`` the
    output channel, column ``k`` the tap (9 of the 64 columns, the rest 0)."""
    rows = torch.zeros(1, C, C, dtype=w1.dtype, device=w1.device)
    rows[0, :, :9] = w1.reshape(9, C).t()
    return _xor_chunks(rows.reshape(1, C, 8, 8)).reshape(-1)


def prepare_pair(cin: int, params, w1_kernel, w2_kernel) -> PreparedPair:
    """Check a pair's weights and lay them out for its kernel through
    ``w1_kernel`` and ``w2_kernel``."""
    w1, s1, b1, w2, s2, b2 = params
    _check_affine(cin, *params)
    if any(p.device != w1.device for p in params):
        raise ValueError("the weights must be on one device")
    kernel = (w1_kernel(w1), s1.contiguous(), b1.contiguous(), w2_kernel(w2),
              s2.contiguous(), b2.contiguous())
    return PreparedPair(tuple(params), kernel)


def prepare_stem(w1: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor,
                 w2: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor) -> PreparedPair:
    """The stem's weights (as :func:`stem` takes them) → what
    :func:`stem_prepared` launches with; done once per model."""
    return prepare_pair(1, (w1, scale1, bias1, w2, scale2, bias2), swizzle_w1, swizzle_w2)


def check_x(x: torch.Tensor, cin: int, x_dtype: torch.dtype, pool: bool,
            prep: PreparedPair) -> None:
    """Shape/dtype/device checks of the input, shared by the stem and down1."""
    if x.dim() != 4 or x.shape[-1] != cin or x.dtype != x_dtype:
        raise ValueError(f"x must be {x_dtype} [B, H, W, {cin}], got {x.dtype} {tuple(x.shape)}")
    if pool and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"pool=True needs even H and W, got {tuple(x.shape)}")
    if prep.params[0].device != x.device:
        raise ValueError("x and the weights must be on one device")


def launch_pair(lib: str, symbol: str, x: torch.Tensor, prep: PreparedPair,
                pool: bool, mid: bool = False) -> torch.Tensor:
    """Launch ``csrc/<lib>.cu``'s ``symbol`` on a CUDA tensor; returns the
    bf16 NHWC output.  With ``mid``, a bf16 ``[B, H, W, 64]`` scratch
    tensor for the intermediate goes before the output."""
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC with a 16-byte aligned start")
    B, H, W, _ = x.shape
    shape = (B, H // 2, W // 2, C) if pool else (B, H, W, C)
    bufs = [torch.empty(shape, dtype=torch.bfloat16, device=x.device)]
    if mid:
        bufs.insert(0, torch.empty((B, H, W, C), dtype=torch.bfloat16, device=x.device))
    fn = getattr(_build.load(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * (7 + len(bufs)) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), *(t.data_ptr() for t in prep.kernel), *(t.data_ptr() for t in bufs),
             B, H, W, int(pool), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, symbol)
    return bufs[-1]


def stem_plain(x: torch.Tensor, w1, s1, b1, w2, s2, b2, pool: bool = True) -> torch.Tensor:
    """The stem in plain PyTorch: x [B, H, W, 1] fp32 (rounded to bf16
    first) → [B, H/2, W/2, 64] (pool) or [B, H, W, 64] bf16."""
    return conv_pair_plain(x.to(torch.bfloat16), w1, s1, b1, w2, s2, b2, pool)


def stem_prepared(x: torch.Tensor, prep: PreparedPair, pool: bool = True) -> torch.Tensor:
    """:func:`stem` with weights from :func:`prepare_stem`."""
    global launches
    check_x(x, 1, torch.float32, pool, prep)
    if x.device.type == "cpu":
        return stem_plain(x, *prep.params, pool=pool)
    out = launch_pair("stem", "ssp_stem_launch", x, prep, pool)
    launches += 1
    return out


def stem(x: torch.Tensor, w1: torch.Tensor, scale1: torch.Tensor, bias1: torch.Tensor,
         w2: torch.Tensor, scale2: torch.Tensor, bias2: torch.Tensor,
         pool: bool = True) -> torch.Tensor:
    """x [B, H, W, 1] fp32 → fused stem output, bf16: ``[B, H/2, W/2, 64]``
    with ``pool=True``, else the unpooled ``[B, H, W, 64]``.

    w1 [3, 3, 1, 64], w2 [3, 3, 64, 64] bf16 (HWIO, as in the JAX
    package); scale/bias fp32 [64], folded inference BN
    (``ssp_torch.models.fast_infer.fold_bn``).  Any H and W (even for
    ``pool``).  CPU tensors run :func:`stem_plain`; CUDA tensors launch
    the kernel.
    """
    return stem_prepared(x, prepare_stem(w1, scale1, bias1, w2, scale2, bias2), pool)
