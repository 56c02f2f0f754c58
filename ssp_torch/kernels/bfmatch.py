"""Cross-checked brute-force matching of SIFT and ORB descriptors,
``cv2.BFMatcher(NORM_L2 or NORM_HAMMING, crossCheck=True).match``.

The CUDA kernel ``ssp_torch/csrc/bfmatch.cu`` replaces no TPU kernel: the
JAX package matches on the host with OpenCV (``ssp/export/classical.py``).
It computes exactly what :func:`bfmatch_plain` computes (and :func:`bfmatch`
runs for CPU tensors), which is OpenCV's result: query row ``q`` is matched
to its nearest train row ``t`` when ``q`` is the nearest query row of ``t``,
nearest meaning the least distance as a float with ties to the lowest
index.  The distances are exact integers before their one rounding:

* L2 (SIFT): SIFT descriptors are integers in [0, 255] stored as float32
  (OpenCV saturates them to uchar); the squared distance is an exact integer
  below 2²⁴ and the distance its IEEE float square root, as OpenCV computes
  it.  :func:`bfmatch` raises for a float descriptor that is not such an
  integer: that precondition is what makes the match exact;
* Hamming (ORB, uint8 rows): the popcount of the xor.

What bounds it on an H100: integer operations, against a few hundred kB
of input.  The least work for the same function is int8 tensor-core work:
two operations per byte pair for L2 (a u8 × u8 product summed in int32,
2.6·10⁸ at 1000 × 1000 SIFT rows) and two per bit pair for Hamming (a 0/1
dot product over the 8·D bits).  The kernel does just that work on the
tensor cores, from the same exact integers: L2 as ``|a|² + |b|² − 2a·b``
(``mma.sync`` u8 × u8 → s32), Hamming as ``popc(a) + popc(b) −
2 popc(a ∧ b)`` (``mma.sync`` b1 AND-popc); its keys stay on the float root.
At a pair of images' sizes the work takes far less than a launch, so the
design is one launch per call: 64 × 128 tiles, per-tile minima stored into
scratch, the last block of each strip (column) of tiles reduces them, and
the last block of all applies the cross-check (counters in the library,
reset by those blocks: no memset).  The minima are found on the exact
integers, the float root taken of the least sum and of any sum that could
share its root.  A call takes up to 1,048,576 query rows and 2,097,152
train rows (16384 tiles a side).

``launches`` counts the calls of :func:`bfmatch` that reach the card (each
is one CUDA launch).
"""

from __future__ import annotations

import ctypes

import torch

from ssp_torch.kernels import _build

launches = 0
_NONE = -1  # the kernel's "no match" key, ~0 as int64
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
_MAX_QUERY, _MAX_TRAIN = 16384 * 64, 16384 * 128  # the kernel's tiles, 64 x 128, per side
_CHUNK = 1 << 22  # elements of a [rows, Nt, D] difference block in the plain version
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def _check(desc1: torch.Tensor, desc2: torch.Tensor) -> bool:
    """Validate the pair; returns whether the norm is Hamming."""
    if desc1.dim() != 2 or desc2.dim() != 2 or desc1.shape[1] != desc2.shape[1]:
        raise ValueError(f"descriptors must be [N1, D] and [N2, D], got {tuple(desc1.shape)} "
                         f"and {tuple(desc2.shape)}")
    if desc1.dtype != desc2.dtype or desc1.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"descriptors must both be float32 (L2) or both uint8 (Hamming), got "
                         f"{desc1.dtype} and {desc2.dtype}")
    if desc1.device != desc2.device:
        raise ValueError(f"descriptors on {desc1.device} and {desc2.device}")
    return desc1.dtype == torch.uint8


def _integer_bytes(desc: torch.Tensor) -> torch.Tensor:
    """SIFT rows as uint8, after checking they are integers in [0, 255]."""
    if desc.numel() and bool(((desc != torch.round(desc)) | (desc < 0) | (desc > 255)).any()):
        raise ValueError("L2 matching takes descriptors that are integers in [0, 255] (SIFT's); "
                         "other values would make the distances inexact")
    return desc.to(torch.uint8)


def sqrt_rn(s: torch.Tensor) -> torch.Tensor:
    """IEEE float32 square root (rounded to nearest) of non-negative int32
    ``s`` below 2²⁴, whatever the accuracy of the library's ``sqrt`` (PyTorch's
    vectorised CPU float32 ``sqrt`` is not correctly rounded): the float of
    the float64 root, moved by one unit in the last place where ``s`` lies
    beyond the square of the midpoint to a neighbour (exact in float64)."""
    x = s.double()
    r = torch.sqrt(x).float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + down.double()) * 0.5
    return torch.where(x > hi * hi, up, torch.where(x < lo * lo, down, r))


def _distances(q: torch.Tensor, t: torch.Tensor, hamming: bool) -> torch.Tensor:
    """[Nq, Nt] float32 distances in integer arithmetic: the L2 distance as
    the float square root of the exact integer sum of squares, or the
    Hamming distance."""
    out = torch.empty((q.shape[0], t.shape[0]), dtype=torch.float32, device=q.device)
    rows = max(1, _CHUNK // max(1, t.shape[0] * q.shape[1]))
    table = _POPCOUNT.to(q.device)
    for r in range(0, q.shape[0], rows):
        a = q[r:r + rows, None, :]
        if hamming:
            s = table[(a ^ t[None]).long()].sum(-1, dtype=torch.int32)
            out[r:r + rows] = s.float()
        else:
            diff = a.int() - t[None].int()
            s = (diff * diff).sum(-1, dtype=torch.int32)
            out[r:r + rows] = sqrt_rn(s)
    return out


def bfmatch_plain(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """The same function in PyTorch: ``desc1`` [Nq, D] query rows, ``desc2``
    [Nt, D] train rows (float32 integers in [0, 255] → L2, uint8 → Hamming)
    → [M, 3] float64 (query row, train row, distance) in query order."""
    hamming = _check(desc1, desc2)
    if not len(desc1) or not len(desc2):
        return torch.zeros((0, 3), dtype=torch.float64, device=desc1.device)
    q = desc1 if hamming else _integer_bytes(desc1)
    t = desc2 if hamming else _integer_bytes(desc2)
    d = _distances(q, t, hamming)
    nn_t = torch.argmin(d, dim=1)  # ties: the first index, OpenCV's strict <
    nn_q = torch.argmin(d, dim=0)
    rows = torch.arange(len(q), device=q.device)
    keep = nn_q[nn_t] == rows
    return torch.stack([rows[keep].double(), nn_t[keep].double(),
                        d[rows[keep], nn_t[keep]].double()], dim=1)


def bfmatch(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """``cv2.BFMatcher(norm, crossCheck=True).match(desc1, desc2)`` as an
    [M, 3] float64 tensor (query row, train row, distance) in query order;
    float32 rows (SIFT) match by L2, uint8 rows (ORB) by Hamming.  CPU
    tensors run :func:`bfmatch_plain`; CUDA tensors launch the kernel."""
    global launches
    hamming = _check(desc1, desc2)
    if desc1.device.type == "cpu":
        return bfmatch_plain(desc1, desc2)
    if desc1.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {desc1.device}")
    if not len(desc1) or not len(desc2):
        return torch.zeros((0, 3), dtype=torch.float64, device=desc1.device)
    q = (desc1 if hamming else _integer_bytes(desc1)).contiguous()
    t = (desc2 if hamming else _integer_bytes(desc2)).contiguous()
    if q.shape[1] % 4 or q.shape[1] > 128:
        raise ValueError(f"the kernel takes rows of 4..128 bytes in steps of 4, got {q.shape[1]}")
    if len(q) > _MAX_QUERY or len(t) > _MAX_TRAIN:
        raise ValueError(f"the kernel takes at most {_MAX_QUERY} query and {_MAX_TRAIN} train "
                         f"rows, got {len(q)} and {len(t)}")
    keys = launch(q, t, hamming)
    launches += 1
    return matches_from_keys(keys)


def matches_from_keys(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's int64 keys [Nq] (distance bits << 32 | train row, or -1
    for no match) → [M, 3] float64 (query row, train row, distance)."""
    rows = torch.nonzero(keys != _NONE)[:, 0]
    k = keys[rows]
    dist = (k >> 32).int().view(torch.float32)
    return torch.stack([rows.double(), (k & 0xFFFFFFFF).double(), dist.double()], dim=1)


def launch(q: torch.Tensor, t: torch.Tensor, hamming: bool) -> torch.Tensor:
    """One launch of the kernel on contiguous CUDA uint8 rows ``q`` [Nq, D]
    and ``t`` [Nt, D] (D a multiple of 4, at most 128) → int64 keys [Nq]:
    distance bits << 32 | train row, or -1 for no match; counts nothing
    (:func:`bfmatch` does).  Launches on one device must not overlap (the
    kernel's counters are one set per device): calls on one stream do
    not."""
    lib = _build.load("bfmatch")
    fn, size = lib.ssp_bfmatch_launch, lib.ssp_bfmatch_scratch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        size.argtypes, size.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    nq, nt = q.shape[0], t.shape[0]
    scratch = torch.empty(size(nq, nt), dtype=torch.int64, device=q.device)
    out = torch.empty(nq, dtype=torch.int64, device=q.device)
    err = fn(q.data_ptr(), t.data_ptr(), nq, nt, q.shape[1] // 4, int(hamming),
             scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ssp_bfmatch_launch")
    return out
