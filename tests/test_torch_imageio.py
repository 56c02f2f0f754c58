"""The port's image decoder (``ssp_torch.data.imageio``, C++ in
``ssp_torch/csrc/imageio_host.cpp``) against ``cv2.imread(path,
cv2.IMREAD_GRAYSCALE)``, which is how the JAX package reads images.

Bar: exact, the same shape and every byte, on JPEGs that OpenCV writes
(qualities, chroma samplings, gray, restart intervals, optimised Huffman
tables, odd sizes down to 1×1, EXIF orientations 1-8 spliced in as APP1, a
noisy quality-100 image whose inverse DCT saturates; progressive, from
OpenCV's scan script and Pillow's, and cut short of its refinement scans),
on JPEGs that Pillow writes (CMYK, RGB-coded, progressive) and on baseline
JPEGs written here (:func:`_baseline_jpeg`: any sampling factors, CMYK,
YCCK, RGB-coded, luma subsampled against chroma), and on PNGs, both those
OpenCV writes (every compression level, so all five row filters appear)
and those written here (gray at 1, 2, 4, 8 and 16 bits, gray+alpha, palette,
RGB and RGBA at 8 and 16 bits, every filter in turn, Adam7, ``gAMA``,
``sRGB``, ``iCCP``, ``cHRM`` and ``sBIT``, an ``eXIf`` orientation).  The
forms the decoder refuses raise ``ValueError`` naming the form.  The
committed fixtures of ``tests/data/torch_imageio`` (read on the card's
machine by ``chip_smoke.py``, which has no OpenCV) decode to the hashes of
their manifest through both OpenCV and the port; :func:`make_fixtures`
wrote them.
"""

import hashlib
import importlib.util
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from ssp_torch.data import imageio
from ssp_torch.data.base import read_gray
from ssp_torch.kernels import _build

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "torch_imageio"
PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _scene(h, w, channels=3, seed=0, noise=12.0):
    """uint8 [h, w, channels] (or [h, w] for 1): gradients, rectangles and
    Gaussian noise, each channel shifted so that color matters."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    out = []
    for c in range(channels):
        img = 110 + 60 * np.sin(xs / (9.0 + 3 * c)) + 40 * np.cos(ys / (13.0 + 2 * c))
        for _ in range(max(2, h * w // 3000)):
            y0, x0 = rng.integers(0, max(h - 2, 1)), rng.integers(0, max(w - 2, 1))
            img[y0:y0 + rng.integers(2, h // 3 + 3), x0:x0 + rng.integers(2, w // 3 + 3)] = \
                rng.uniform(0, 255)
        out.append(img + rng.normal(0, noise, (h, w)))
    out = np.clip(np.rint(np.stack(out, -1)), 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def _jpeg(img, quality=90, sampling=None, params=()):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality, *params]
    if sampling is not None:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def _exif_app1(orientation, little=True):
    """An APP1 segment with a TIFF IFD0 holding only the Orientation tag."""
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body, tiff


def _with_exif(jpeg: bytes, orientation, little=True) -> bytes:
    return jpeg[:2] + _exif_app1(orientation, little)[0] + jpeg[2:]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(raw_rows, bpp, filters):
    """Filter each row of bytes with the given type (0-4), as an encoder."""
    out, prev = [], np.zeros(len(raw_rows[0]), np.int16)
    pad = np.zeros(bpp, np.int16)
    for y, row in enumerate(raw_rows):
        cur = np.frombuffer(row, np.uint8).astype(np.int16)
        a, c = np.concatenate([pad, cur[:-bpp]]), np.concatenate([pad, prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        f = filters[y % len(filters)]
        pred = (0, a, prev, (a + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c)))[f]
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass


def _png_rows(samples, depth):
    """Each row of ``samples`` [h, w, channels] as its bytes at ``depth``."""
    h = samples.shape[0]
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    per = 8 // depth
    rows = []
    for y in range(h):
        v = samples[y, :, 0].astype(np.uint8)
        v = np.concatenate([v, np.zeros((-len(v)) % per, np.uint8)]).reshape(-1, per)
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        rows.append((v << shifts).sum(1).astype(np.uint8).tobytes())
    return rows


def _png(samples, depth, ctype, palette=None, extra=b"", filters=(0, 1, 2, 3, 4), interlace=0):
    """A PNG of ``samples`` [h, w, channels] (ints < 2**depth), written here;
    ``interlace=1``: Adam7, each pass a sub-image filtered on its own (empty
    passes have no bytes)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    data = PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    data += extra
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    passes = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace else [samples]
    raw = b"".join(_filter_rows(_png_rows(p, depth), bpp, filters) for p in passes if p.size)
    data += _chunk(b"IDAT", zlib.compress(raw))
    return data + _chunk(b"IEND", b"")


def _png_filters(data: bytes):
    """The set of row filter types of a non-interlaced PNG."""
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, ctype = ihdr[:4]
    rowbytes = (w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (rowbytes + 1)] for y in range(h)}


def _check(tmp_path, data: bytes, name="img"):
    """Write ``data``, decode it with both; assert equal; return the image."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert want is not None
    got = imageio.decode_gray(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _std_huffman():
    """The four Huffman tables of OpenCV's baseline writer, which are the
    standard's (K.3 of the JPEG standard): [(class, id, counts, symbols)] for
    DC 0, AC 0, DC 1, AC 1."""
    data = _jpeg(np.zeros((8, 8, 3), np.uint8), 90)
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xC4:
            seg, p = data[pos + 4:pos + 2 + n], 0
            while p < len(seg):
                counts = seg[p + 1:p + 17]
                out.append((seg[p] >> 4, seg[p] & 15, counts, seg[p + 17:p + 17 + sum(counts)]))
                p += 17 + sum(counts)
        pos += 2 + n
    return out


def _huffman_codes(counts, symbols):
    """symbol → (code, length) of a canonical Huffman table."""
    code, k, table = 0, 0, {}
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[symbols[k]] = (code, length)
            k, code = k + 1, code + 1
        code <<= 1
    return table


_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                    48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                    22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47,
                    55, 62, 63])


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _baseline_jpeg(planes, factors, hw, ids=None, adobe=None, jfif=True, quant=4):
    """A baseline JPEG [hw] written here, for the forms neither OpenCV nor
    Pillow writes: component i holds ``planes[i]`` (uint8, cropped to its
    sampled size) at sampling factors ``factors[i]`` = (h, v), component ids
    ``ids``; one interleaved scan, the standard Huffman tables, a flat
    quantiser; an APP14 with transform ``adobe`` (None: none), a JFIF APP0
    unless ``jfif`` is false or there is an APP14."""
    H, W = hw
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    ids = ids or list(range(1, len(planes) + 1))
    tables = _std_huffman()
    dc, ac = _huffman_codes(*tables[0][2:]), _huffman_codes(*tables[1][2:])
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * \
        np.where(k == 0, np.sqrt(0.125), 0.5)[:, None]
    blocks = []
    for plane, (h, v) in zip(planes, factors):
        dw, dh = -(-W * h // hmax), -(-H * v // vmax)
        p = np.asarray(plane, np.float64)[:dh, :dw]
        p = np.pad(p, ((0, mcuy * v * 8 - dh), (0, mcux * h * 8 - dw)), mode="edge") - 128
        tiles = p.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ui,yxij,vj->yxuv", basis, tiles, basis) / quant
        blocks.append(np.rint(coef).astype(int).reshape(mcuy * v, mcux * h, 64)[..., _ZIGZAG])
    bits = []

    def put(code, n):
        bits.extend((code >> (n - 1 - i)) & 1 for i in range(n))

    def put_value(table, run, value):
        size = int(abs(value)).bit_length()
        put(*table[(run << 4) | size])
        if size:
            put(value if value > 0 else value + (1 << size) - 1, size)

    pred = [0] * len(planes)
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (h, v) in enumerate(factors):
                for by in range(v):
                    for bx in range(h):
                        blk = blocks[c][my * v + by, mx * h + bx]
                        put_value(dc, 0, blk[0] - pred[c])
                        pred[c], run = blk[0], 0
                        for x in blk[1:]:
                            if x == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            put_value(ac, run, x)
                            run = 0
                        if run:
                            put(*ac[0x00])
    bits.extend([1] * (-len(bits) % 8))
    data = bytes(np.packbits(np.array(bits, np.uint8))).replace(b"\xff", b"\xff\x00")
    out = b"\xff\xd8"
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    elif jfif:
        out += _segment(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0")
    out += _segment(0xDB, bytes([0]) + bytes([quant] * 64))
    out += _segment(0xC0, struct.pack(">BHHB", 8, H, W, len(planes)) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, factors)))
    out += _segment(0xC4, b"".join(bytes([(tc << 4) | th]) + counts + syms
                                   for tc, th, counts, syms in tables[:2]))
    out += _segment(0xDA, bytes([len(planes)]) + b"".join(bytes([i, 0]) for i in ids) +
                    bytes([0, 63, 0]))
    return out + data + b"\xff\xd9"


def _lossless_jpeg(planes, factors, hw, predictor=1, pt=0, restart_rows=0, ids=None, adobe=None,
                   jfif=False, precision=8, sof=0xC3):
    """A lossless JPEG (SOF3, ITU-T T.81 Annex H) [hw] written here: one
    interleaved scan (one component: its own), component i holding
    ``planes[i]`` >> ``pt`` at sampling factors ``factors[i]``, predictor
    ``predictor`` (1-7), a restart every ``restart_rows`` MCU rows (each
    restarts the first-row prediction), one Huffman table for every
    component (DC-style categories 0-16), no quantisation table."""
    H, W = hw
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    ids = ids or list(range(1, len(planes) + 1))
    one = len(planes) == 1
    comps = []
    for plane, (h, v) in zip(planes, factors):
        dw, dh = -(-W * h // hmax), -(-H * v // vmax)
        comps.append((np.asarray(plane, np.int64)[:dh, :dw] >> pt, h, v))
    mcux = comps[0][0].shape[1] if one else -(-W // hmax)
    mcuy = comps[0][0].shape[0] if one else -(-H // vmax)
    initial = 1 << (precision - pt - 1)

    def differences(x, rows_per_mcu_row):
        d = np.zeros_like(x)
        for r in range(x.shape[0]):
            first = r == 0 or (restart_rows and r % (rows_per_mcu_row * restart_rows) == 0)
            for c in range(x.shape[1]):
                if first:
                    p = initial if c == 0 else x[r, c - 1]
                elif c == 0:
                    p = x[r - 1, 0]
                else:
                    a, b, cc = int(x[r, c - 1]), int(x[r - 1, c]), int(x[r - 1, c - 1])
                    p = (a, b, cc, a + b - cc, a + ((b - cc) >> 1), b + ((a - cc) >> 1),
                         (a + b) >> 1)[predictor - 1]
                d[r, c] = (x[r, c] - p) & 0xFFFF
        return d

    diffs = [differences(x, 1 if one else v) for x, _, v in comps]
    counts = bytes([0, 3] + [1] * 14)  # 17 codes: categories 0-16
    code = _huffman_codes(counts, bytes(range(17)))
    bits, out = [], b""

    def put(value, n):
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def flush():
        nonlocal bits, out
        bits.extend([1] * (-len(bits) % 8))
        out += bytes(np.packbits(np.array(bits, np.uint8))).replace(b"\xff", b"\xff\x00")
        bits = []

    rst = 0
    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            flush()
            out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
        for mx in range(mcux):
            for d, (x, h, v) in zip(diffs, comps):
                bh, bv = (1, 1) if one else (h, v)
                for yy in range(bv):
                    for xx in range(bh):
                        r, c = my * bv + yy, mx * bh + xx
                        value = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] else 0
                        if value == 32768:
                            put(*code[16])
                            continue
                        value -= 65536 if value > 32768 else 0
                        size = abs(value).bit_length()
                        put(*code[size])
                        if size:
                            put(value if value > 0 else value + (1 << size) - 1, size)
    flush()
    head = b"\xff\xd8"
    if adobe is not None:
        head += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))
    elif jfif:
        head += _segment(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0")
    head += _segment(sof, struct.pack(">BHHB", precision, H, W, len(planes)) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, factors)))
    head += _segment(0xC4, bytes([0]) + counts + bytes(range(17)))
    if restart_rows:
        head += _segment(0xDD, struct.pack(">H", restart_rows * mcux))
    head += _segment(0xDA, bytes([len(planes)]) + b"".join(bytes([i, 0]) for i in ids) +
                     bytes([predictor, 0, pt]))
    return head + out + b"\xff\xd9"


_WRITER = {}


def _arith_writer() -> Path:
    """``tests/torch_jpeg_writer.cpp`` built against the system libjpeg
    (libjpeg-turbo, arithmetic coding on) into a directory of this process
    (removed at its exit), once; skips where there is no g++ or no libjpeg
    headers."""
    if "exe" not in _WRITER:
        import atexit
        import tempfile

        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("no g++: cannot build the arithmetic JPEG writer")
        work = tempfile.mkdtemp(prefix="ssp_jpeg_writer_")
        atexit.register(shutil.rmtree, work, True)
        exe = Path(work) / "torch_jpeg_writer"
        run = subprocess.run([gxx, "-O1", str(ROOT / "tests" / "torch_jpeg_writer.cpp"), "-ljpeg",
                              "-o", str(exe)], capture_output=True, text=True)
        if run.returncode != 0:
            pytest.skip(f"cannot build the arithmetic JPEG writer (libjpeg headers?): {run.stderr}")
        _WRITER["exe"] = exe
    return _WRITER["exe"]


def _arith_jpeg(img, quality=90, progressive=False, restart=0, hv="22", dac=(0, 1, 5),
                keep_dac=True) -> bytes:
    """``img`` (uint8 [h, w] gray or [h, w, 3] RGB) written by the system
    libjpeg: arithmetic-coded (SOF9, SOF10 progressive), luma sampling
    ``hv``, a restart every ``restart`` MCUs, DAC conditioning (L, U, K) of
    every table; ``keep_dac=False`` drops the DAC segments (libjpeg writes
    one before each scan), so that the decoder takes the defaults."""
    import tempfile

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    with tempfile.TemporaryDirectory() as d:
        raw, out = Path(d) / "in.raw", Path(d) / "out.jpg"
        raw.write_bytes(img.tobytes())
        subprocess.run([str(_arith_writer()), str(raw), str(h), str(w),
                        str(1 if img.ndim == 2 else 3), str(quality), str(int(progressive)),
                        str(restart), hv, *map(str, dac), str(out)],
                       check=True)
        data = out.read_bytes()
    if not keep_dac:
        data = _drop_segments(data, 0xCC)
    return data


def _drop_segments(data: bytes, marker: int) -> bytes:
    """``data`` without its marker segments of type ``marker`` (those before
    each scan; entropy-coded data is copied as it is)."""
    out, pos = data[:2], 2
    while True:
        m = data[pos + 1]
        if m == 0xD9:
            return out + data[pos:]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        if m != marker:
            out += data[pos:end]
        pos = end


def _scan_units(data: bytes):
    """A JPEG split at its scans: [head, scan 1, ..., scan n, EOI], each scan
    with the table segments (DHT, DRI) just before it."""
    pos, units, start = 2, [], 2
    while True:
        m = data[pos + 1]
        if m == 0xD9:
            return [data[:units[0][0]]] + [data[a:b] for a, b in units] + [data[pos:]]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
            units.append((start, end))
            start = end
        elif m not in (0xC4, 0xDD):
            start = end
        pos = end


def _pillow_jpeg(img, mode, **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


# -- JPEG ----------------------------------------------------------------------

S420, S422, S444 = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)


@pytest.mark.parametrize("quality", [50, 75, 90, 96, 100])
def test_jpeg_quality(tmp_path, quality):
    _check(tmp_path, _jpeg(_scene(72, 104, seed=quality), quality, S420))


@pytest.mark.parametrize("sampling", ["420", "422", "444", "411", "440"])
def test_jpeg_chroma_sampling(tmp_path, sampling):
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    _check(tmp_path, _jpeg(_scene(61, 83, seed=1), 90, factor))


@pytest.mark.parametrize("hw", [(240, 320), (17, 9), (1, 1)])
def test_jpeg_gray_one_component(tmp_path, hw):
    """One component, as ``scripts/make_coco_tree.py`` writes COCO's
    stand-ins (quality 96)."""
    data = _jpeg(_scene(*hw, channels=1, seed=2), 96)
    assert data[data.index(b"\xff\xc0") + 9] == 1  # Nf = 1
    _check(tmp_path, data)


@pytest.mark.parametrize("interval,sampling", [(1, S444), (3, S420), (7, S422), (2, None)])
def test_jpeg_restart_intervals(tmp_path, interval, sampling):
    img = _scene(67, 91, seed=3) if sampling is not None else _scene(67, 91, 1, seed=3)
    data = _jpeg(img, 85, sampling, (cv2.IMWRITE_JPEG_RST_INTERVAL, interval))
    assert b"\xff\xdd" in data and b"\xff\xd1" in data
    _check(tmp_path, data)


@pytest.mark.parametrize("channels", [1, 3])
def test_jpeg_optimised_huffman_tables(tmp_path, channels):
    img = _scene(88, 120, channels, seed=4)
    plain, optimised = _jpeg(img, 90), _jpeg(img, 90, params=(cv2.IMWRITE_JPEG_OPTIMIZE, 1))
    assert optimised != plain
    _check(tmp_path, optimised)


@pytest.mark.parametrize("hw", [(1, 1), (17, 9), (9, 17), (8, 8), (15, 16), (239, 321)])
@pytest.mark.parametrize("sampling", [S420, S444])
def test_jpeg_odd_sizes(tmp_path, hw, sampling):
    _check(tmp_path, _jpeg(_scene(*hw, seed=hw[0] * hw[1]), 90, sampling))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("little", [True, False], ids=["II", "MM"])
def test_jpeg_exif_orientation(tmp_path, orientation, little):
    """OpenCV applies the EXIF orientation; so does the port (orientations
    5-8 transpose the shape)."""
    data = _jpeg(_scene(37, 53, seed=5), 90, S420)
    upright = imageio.decode_jpeg(data)
    got = _check(tmp_path, _with_exif(data, orientation, little))
    assert got.shape == ((53, 37) if orientation >= 5 else (37, 53))
    if orientation == 6:
        np.testing.assert_array_equal(got, np.rot90(upright, -1))


def test_jpeg_noisy_q100_saturates(tmp_path):
    """Pixel noise of 0 and 255 at quality 100: the inverse DCT's sums leave
    0-255 and go through libjpeg's range-limit table."""
    rng = np.random.default_rng(6)
    img = (rng.integers(0, 2, (64, 64, 3)) * 255).astype(np.uint8)
    for sampling in (S444, S420):
        got = _check(tmp_path, _jpeg(img, 100, sampling))
        assert (got == 0).mean() > 0.05 and (got == 255).mean() > 0.05


# -- PNG -------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1, 3, 6, 9])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_written_by_opencv(tmp_path, level, channels):
    img = _scene(45, 77, channels, seed=level)
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert ok
    _check(tmp_path, buf.tobytes())


def test_png_opencv_filters_cover_all_five(tmp_path):
    """OpenCV's writer (libpng's adaptive filtering) uses every filter type
    over these levels; each image decodes exactly."""
    seen = set()
    for level in range(10):
        for channels in (1, 3):
            img = _scene(60, 90, channels, seed=10 + level, noise=3.0)
            img[20:30] = np.random.default_rng(level).integers(0, 256, img[20:30].shape)
            img[40:50] = 7  # a band of noise and a flat band: filter 0 wins on some rows
            ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            seen |= _png_filters(buf.tobytes())
            _check(tmp_path, buf.tobytes())
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("channels", [1, 3])
def test_png_16bit_written_by_opencv(tmp_path, channels):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 65536, (33, 47, channels) if channels > 1 else (33, 47),
                       dtype=np.uint16)
    ok, buf = cv2.imencode(".png", img)
    _check(tmp_path, buf.tobytes())


PNG_FORMS = [  # (colour type, bit depth, channels)
    (0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1),
    (4, 8, 2), (4, 16, 2), (2, 8, 3), (2, 16, 3), (6, 8, 4), (6, 16, 4),
    (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1),
]


@pytest.mark.parametrize("ctype,depth,channels", PNG_FORMS,
                         ids=[f"type{c}-{d}bit" for c, d, _ in PNG_FORMS])
def test_png_forms_written_here(tmp_path, ctype, depth, channels):
    """Each colour type and bit depth, each row filter in turn; a palette
    shorter than the index range (indices past it read as black)."""
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 29, 43
    top = 2 ** depth
    samples = rng.integers(0, top, (h, w, channels))
    samples[:8] = np.linspace(0, top - 1, w).astype(np.int64)[None, :, None]  # ramps
    palette = None
    if ctype == 3:
        n = max(1, min(top - 1, 200))  # the last indices lie past the palette
        palette = rng.integers(0, 256, (n, 3))
    data = _png(samples, depth, ctype, palette)
    assert _png_filters(data) == {0, 1, 2, 3, 4}
    _check(tmp_path, data)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_png_exif_orientation(tmp_path, orientation):
    """OpenCV applies an ``eXIf`` chunk's orientation to PNG too."""
    gray = _scene(21, 34, 1, seed=8)[..., None]
    tiff = _exif_app1(orientation, little=False)[1]
    got = _check(tmp_path, _png(gray, 8, 0, extra=_chunk(b"eXIf", tiff)))
    assert got.shape == ((34, 21) if orientation >= 5 else (21, 34))


def test_png_rgb_at_kitti_size(tmp_path):
    """KITTI's 375×1242 color frame: libpng's 15-bit truncated luma, which
    differs from OpenCV's 14-bit ``cvtColor`` (``rgb_to_gray``)."""
    from ssp_torch.data.base import rgb_to_gray

    rgb = _scene(375, 1242, 3, seed=9)
    path = tmp_path / "kitti.png"
    cv2.imwrite(str(path), rgb[..., ::-1])
    got = imageio.decode_gray(path)
    np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    np.testing.assert_array_equal(got, (9797 * r + 19234 * g + 3737 * b) >> 15)
    assert (got != rgb_to_gray(rgb)).mean() > 0.1


# -- progressive JPEG ---------------------------------------------------------------

PROGRESSIVE = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", ["gray", "420", "422", "444"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_progressive_jpeg(tmp_path, quality, sampling, restart):
    """OpenCV's progressive script (libjpeg's jpeg_simple_progression: DC
    first and refinement, AC first and refinement with end-of-band runs,
    interleaved and single-component scans), with and without restarts."""
    img = _scene(40, 56, 1 if sampling == "gray" else 3, seed=quality + restart)
    factor = None if sampling == "gray" else getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    params = PROGRESSIVE + ((cv2.IMWRITE_JPEG_RST_INTERVAL, restart) if restart else ())
    data = _jpeg(img, quality, factor, params)
    assert b"\xff\xc2" in data and (b"\xff\xd0" in data) == bool(restart)
    _check(tmp_path, data)


@pytest.mark.parametrize("hw", [(1, 1), (17, 9), (239, 321)])
def test_progressive_jpeg_sizes(tmp_path, hw):
    _check(tmp_path, _jpeg(_scene(*hw, seed=hw[1]), 90, S420, PROGRESSIVE))


@pytest.mark.parametrize("orientation", [1, 6, 8])
def test_progressive_jpeg_exif_orientation(tmp_path, orientation):
    data = _jpeg(_scene(37, 53, seed=5), 90, S420, PROGRESSIVE)
    got = _check(tmp_path, _with_exif(data, orientation))
    assert got.shape == ((53, 37) if orientation >= 5 else (37, 53))


@pytest.mark.parametrize("kind", ["RGB", "L", "RGB-444-optimized"])
def test_progressive_jpeg_written_by_pillow(tmp_path, kind):
    """Pillow's progressive script (libjpeg-turbo's, with Huffman tables
    optimised per scan)."""
    img = _scene(45, 61, 1 if kind == "L" else 3, seed=22)
    kw = {"subsampling": 0, "optimize": True} if kind.endswith("optimized") else {}
    data = _pillow_jpeg(img, kind[:3].rstrip("-"), progressive=True, quality=85, **kw)
    assert b"\xff\xc2" in data
    _check(tmp_path, data)


def test_progressive_jpeg_cut_refinement(tmp_path):
    """OpenCV's progressive file with some refinement scans cut out, EOI
    kept.  libjpeg smooths the blocks (jdcoefct.c, libjpeg-turbo's 5×5
    estimate) where one of the first nine AC coefficients of a component is
    short of its last bit; the port smooths them alike (it refused these
    files before): the luma's refinement cut, the AC scans cut (the DC
    estimated too), and the chroma's or the DC's refinement cut."""
    data = _jpeg(_scene(45, 61, seed=23), 90, S420, PROGRESSIVE)
    units = _scan_units(data)
    assert len(units) == 12  # head, 10 scans, EOI
    # scans 8 and 9: the chroma's last AC bit; 7: the DC's; 10: the luma's
    for keep in (units[:8] + units[10:], units[:7] + units[8:]):
        _check(tmp_path, b"".join(keep))
    for keep in (units[:10] + units[11:], units[:6] + units[-1:]):
        _check(tmp_path, b"".join(keep))


# -- CMYK, YCCK, RGB-coded JPEG and the sampling factors ----------------------------


@pytest.mark.parametrize("kw", [{}, {"subsampling": 1}, {"subsampling": 2},
                                {"progressive": True}],
                         ids=["444", "h2v1", "h2v2", "progressive"])
def test_cmyk_jpeg_written_by_pillow(tmp_path, kw):
    """Pillow's CMYK JPEG (Adobe transform 0, inverted ink): every component
    through the inverse DCT, libjpeg's upsampling of the subsampled ones,
    OpenCV's CMYK to gray."""
    data = _pillow_jpeg(_scene(40, 56, 4, seed=24), "CMYK", quality=90, **kw)
    assert b"Adobe" in data
    _check(tmp_path, data)


@pytest.mark.parametrize("progressive", [False, True])
def test_rgb_coded_jpeg_written_by_pillow(tmp_path, progressive):
    """Pillow's ``keep_rgb``: components R, G, B under an Adobe transform 0,
    converted to gray by libjpeg-turbo's rgb_gray_convert."""
    data = _pillow_jpeg(_scene(40, 56, seed=25), "RGB", keep_rgb=True, quality=90,
                        progressive=progressive)
    _check(tmp_path, data)


SAMPLINGS = [  # three components' (h, v): each upsampling route of jdsample.c
    [(2, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 1)], [(1, 2), (2, 2), (1, 1)],
    [(1, 1), (1, 2), (1, 1)], [(1, 1), (2, 1), (2, 1)], [(1, 1), (3, 1), (1, 1)],
    [(1, 1), (4, 2), (1, 1)], [(4, 2), (1, 1), (1, 1)]]


@pytest.mark.parametrize("colour", ["ycbcr", "adobe-rgb", "rgb-ids"])
@pytest.mark.parametrize("factors", SAMPLINGS, ids=["".join(f"{h}{v}" for h, v in f)
                                                    for f in SAMPLINGS])
def test_sampling_factors(tmp_path, factors, colour):
    """Luma subsampled against chroma (it goes through the upsampler), and
    RGB-coded files (Adobe transform 0, or ids R, G, B with no marker) whose
    components are subsampled: fancy h2v1, h1v2 and h2v2, replication for
    the rest, at sizes down to 1×1."""
    img = _scene(37, 45, seed=len(factors) + factors[0][0])
    kw = {"ycbcr": {}, "adobe-rgb": {"adobe": 0},
          "rgb-ids": {"ids": [82, 71, 66], "jfif": False}}[colour]
    for hw in ((37, 45), (9, 17), (2, 3), (1, 1)):
        _check(tmp_path, _baseline_jpeg([img[..., c] for c in range(3)], factors, hw, **kw))


@pytest.mark.parametrize("adobe", [0, 2, None], ids=["cmyk", "ycck", "no-adobe"])
@pytest.mark.parametrize("factors", [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                     [(1, 1), (2, 1), (1, 2), (1, 1)]],
                         ids=["1111", "2112", "1221"])
def test_four_component_jpeg(tmp_path, factors, adobe):
    """Four components: CMYK (Adobe transform 0, or no marker), YCCK
    (transform 2: libjpeg's YCC to RGB tables, inverted, then K)."""
    img = _scene(33, 41, 4, seed=26)
    _check(tmp_path, _baseline_jpeg([img[..., c] for c in range(4)], factors, (33, 41),
                                    adobe=adobe, jfif=False))


@pytest.mark.parametrize("factors,match", [([(2, 1), (3, 1), (1, 1)], "fractional"),
                                           ([(1, 1), (3, 3), (1, 1)], "10 blocks")])
def test_sampling_libjpeg_refuses(tmp_path, factors, match):
    """Factors libjpeg refuses (OpenCV returns None): refused alike."""
    img = _scene(16, 24, seed=27)
    data = _baseline_jpeg([img[..., c] for c in range(3)], factors, (16, 24), adobe=0)
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    assert cv2.imread(str(path), 0) is None
    _refused(tmp_path, data, match)


# -- Adam7 and gamma-tagged PNG --------------------------------------------------------


def _samples(ctype, depth, channels, hw, seed):
    """Seeded samples [h, w, channels] < 2**depth, the first rows gray
    (r = g = b), and a palette for colour type 3 (gray entries first)."""
    rng = np.random.default_rng(seed)
    samples = rng.integers(0, 2 ** depth, (*hw, channels))
    samples[:2] = samples[:2, :, :1]
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (min(2 ** depth, 200), 3))
        palette[:4] = palette[:4, :1]
    return samples, palette


@pytest.mark.parametrize("hw", [(5, 3), (33, 17)])
@pytest.mark.parametrize("ctype,depth,channels", PNG_FORMS,
                         ids=[f"type{c}-{d}bit" for c, d, _ in PNG_FORMS])
def test_adam7_png_forms(tmp_path, ctype, depth, channels, hw):
    """Each colour type and bit depth interlaced: seven passes of their own
    row widths (some empty below 8×8), each filtered from a zero row."""
    samples, palette = _samples(ctype, depth, channels, hw, depth * 10 + ctype)
    _check(tmp_path, _png(samples, depth, ctype, palette, interlace=1))


def _icc_profile():
    cms = pytest.importorskip("PIL.ImageCms")
    return cms.ImageCmsProfile(cms.createProfile("sRGB")).tobytes()


GAMMA_TAGS = ["gAMA-45455", "gAMA-100000", "gAMA-220000", "sRGB", "iCCP", "cHRM"]
GAMMA_FORMS = [(2, 8, 3), (2, 16, 3), (6, 8, 4), (6, 16, 4), (3, 8, 1), (3, 4, 1)]


@pytest.mark.parametrize("ctype,depth,channels", GAMMA_FORMS,
                         ids=[f"type{c}-{d}bit" for c, d, _ in GAMMA_FORMS])
@pytest.mark.parametrize("tag", GAMMA_TAGS)
def test_gamma_tagged_png(tmp_path, tag, ctype, depth, channels):
    """libpng's rgb_to_gray through its gamma tables (8-bit tables; 16-bit
    ones with a shift of 5, before the strip to 8 bits; palette entries
    through the 8-bit ones), for a ``gAMA`` within 5% of 1 none; ``sRGB``
    is gamma 45455; ``iCCP`` (an sRGB profile or not) and ``cHRM`` change
    nothing (OpenCV sets the coefficients).  Interlaced too."""
    if tag.startswith("gAMA"):
        extra = _chunk(b"gAMA", struct.pack(">I", int(tag[5:])))
    elif tag == "sRGB":
        extra = _chunk(b"sRGB", b"\0")
    elif tag == "iCCP":
        extra = _chunk(b"iCCP", b"sRGB profile\0\0" + zlib.compress(_icc_profile()))
    else:
        extra = _chunk(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000,
                                            15000, 6000))
    samples, palette = _samples(ctype, depth, channels, (24, 32), depth + ctype)
    for interlace in (0, 1):
        _check(tmp_path, _png(samples, depth, ctype, palette, extra=extra, interlace=interlace))


def _gama(value):
    return _chunk(b"gAMA", struct.pack(">I", value))


SRGB = _chunk(b"sRGB", b"\0")


@pytest.mark.parametrize("case", [
    "sRGB-then-gAMA", "gAMA-then-sRGB", "two-gAMA", "gAMA-after-PLTE", "gAMA-after-IDAT",
    "gAMA-of-3-bytes", "sRGB-of-2-bytes", "sRGB-intent-7", "gAMA-0", "gAMA-2^31",
    "gAMA-5", "gAMA-2^31-1", "sBIT-12", "sBIT-8", "sBIT-4-mixed", "sBIT-too-deep",
    "iCCP-and-gAMA"])
def test_gamma_chunk_rules(tmp_path, case):
    """Which chunk sets the gamma, as libpng 1.6.58 has it: sRGB wins over
    gAMA, the first gAMA over a later one; chunks after PLTE or IDAT, of the
    wrong length or out of range are ignored; an ``iCCP`` leaves the gAMA
    in force; a valid ``sBIT`` sets the 16-bit tables' shift."""
    rgb, palette = _samples(2, 16 if case.startswith("sBIT") else 8, 3, (24, 32), 28)
    extra, post = {
        "sRGB-then-gAMA": (SRGB + _gama(220000), b""),
        "gAMA-then-sRGB": (_gama(100000) + SRGB, b""),
        "two-gAMA": (_gama(220000) + _gama(45455), b""),
        "gAMA-after-PLTE": (b"", _gama(220000)),
        "gAMA-after-IDAT": (b"", b""),
        "gAMA-of-3-bytes": (_chunk(b"gAMA", b"\0\xb1\x8f"), b""),
        "sRGB-of-2-bytes": (_chunk(b"sRGB", b"\0\0"), b""),
        "sRGB-intent-7": (_chunk(b"sRGB", b"\7"), b""),
        "gAMA-0": (_gama(0), b""),
        "gAMA-2^31": (_gama(1 << 31), b""),
        "gAMA-5": (_gama(5), b""),
        "gAMA-2^31-1": (_gama((1 << 31) - 1), b""),
        "sBIT-12": (_gama(45455) + _chunk(b"sBIT", bytes([12, 12, 12])), b""),
        "sBIT-8": (_gama(220000) + _chunk(b"sBIT", bytes([8, 8, 8])), b""),
        "sBIT-4-mixed": (_gama(45455) + _chunk(b"sBIT", bytes([4, 9, 6])), b""),
        "sBIT-too-deep": (_gama(45455) + _chunk(b"sBIT", bytes([17, 8, 8])), b""),
        "iCCP-and-gAMA": (_chunk(b"iCCP", b"p\0\0" + zlib.compress(_icc_profile())) +
                          _gama(220000), b""),
    }[case]
    depth = 16 if case.startswith("sBIT") else 8
    if case == "gAMA-after-PLTE":  # a suggested palette in an RGB file, then gAMA
        extra = _chunk(b"PLTE", bytes(range(48))) + _gama(220000)
    data = _png(rgb, depth, 2, extra=extra)
    if case == "gAMA-after-IDAT":
        data = data[:-12] + _gama(220000) + data[-12:]
    _check(tmp_path, data)


@pytest.mark.parametrize("gamma", [45455, 220000, 44517209, 471012991])
def test_gamma_16bit_every_gray_value(tmp_path, gamma):
    """Every 16-bit gray value (r = g = b) of a gAMA-tagged RGB file: libpng
    takes it through its 16→8 table, whose boundaries sit on the rounding of
    two reciprocals (these gammas separate that from png_product2's)."""
    v = np.arange(1 << 16).reshape(256, 256)
    _check(tmp_path, _png(np.repeat(v[..., None], 3, -1), 16, 2, extra=_gama(gamma)))


def test_gamma_below_5_refused(tmp_path):
    """A gAMA of 1-4: its reciprocal overflows libpng's fixed point, so the
    screen gamma stays unset and libpng takes other tables ("from 1" with
    the file's gamma, gamma 1 from file to screen); read as OpenCV reads it
    (it was refused before), in every colour form, and as gray."""
    a = np.arange(256)
    grid = np.stack([np.repeat(a, 256).reshape(256, 256), np.tile(a, 256).reshape(256, 256),
                     np.full((256, 256), 7)], -1)
    for gamma in (1, 2, 3, 4):
        _check(tmp_path, _png(grid, 8, 2, extra=_gama(gamma)))
        for ctype, depth, channels in GAMMA_FORMS:
            samples, palette = _samples(ctype, depth, channels, (16, 24), 29 + gamma)
            _check(tmp_path, _png(samples, depth, ctype, palette, extra=_gama(gamma)))
        rgb, _ = _samples(2, 8, 3, (8, 8), 29)
        _check(tmp_path, _png(rgb[..., :1], 8, 0, extra=_gama(gamma)))
    v = np.arange(1 << 16).reshape(256, 256)
    _check(tmp_path, _png(np.repeat(v[..., None], 3, -1), 16, 2, extra=_gama(3)))


# -- what is refused ----------------------------------------------------------------


def _refused(tmp_path, data: bytes, match: str):
    path = tmp_path / "bad.bin"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        imageio.decode_gray(path)
    assert str(path) in str(err.value)


def _sof_replaced(data: bytes, marker: int, body_edit=None) -> bytes:
    at = data.index(b"\xff\xc0")
    n = struct.unpack(">H", data[at + 2:at + 4])[0]
    body = data[at + 4:at + 2 + n]
    if body_edit is not None:
        body = body_edit(body)
    return data[:at] + bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body + \
        data[at + 2 + n:]


def test_progressive_jpeg_refused(tmp_path):
    """A progressive JPEG is read byte for byte (it was refused before);
    cut inside one of its scans it is read as OpenCV reads it (libjpeg's
    fake EOI, the scan's blocks past the cut left as they are, smoothed)."""
    data = _jpeg(_scene(40, 56, seed=11), 90, params=(cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    assert b"\xff\xc2" in data
    _check(tmp_path, data)
    units = _scan_units(data)
    cut = sum(len(u) for u in units[:3]) + 40  # inside the third scan's header
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:cut])
    assert cv2.imread(str(path), 0) is None
    _refused(tmp_path, data[:cut], "corrupt JPEG")
    cut = sum(len(u) for u in units[:4]) - 10  # inside the third scan's data
    assert data.rfind(b"\xff\xda", 0, cut) + 14 < cut
    _check(tmp_path, data[:cut])


@pytest.mark.parametrize("marker,match", [(0xC3, "lossless"),
                                          (0xC5, "hierarchical"), (0xC9, None),
                                          (0xCA, "progression parameters")])
def test_other_jpeg_processes_refused(tmp_path, marker, match):
    """A baseline file's Huffman-coded body under another SOF: read as
    OpenCV reads it (SOF9: decoded as arithmetic-coded data), or refused by
    both (SOF3: a lossless file in YCbCr; SOF10: the scan's parameters are
    not a progressive scan's; SOF5: hierarchical)."""
    data = _sof_replaced(_jpeg(_scene(24, 32, seed=12)), marker)
    path = tmp_path / "sof.jpg"
    path.write_bytes(data)
    if match is None:
        _check(tmp_path, data)
    else:
        assert cv2.imread(str(path), 0) is None
        _refused(tmp_path, data, match)


def test_12bit_cmyk_and_rgb_jpeg_refused(tmp_path):
    """12-bit JPEG stays refused; CMYK and RGB-coded JPEG are read byte for
    byte (they were refused before): a four-component file with an Adobe
    transform 0, and OpenCV's YCbCr data under an Adobe transform 0 with no
    JFIF marker, which libjpeg then takes for R, G, B."""
    base = _jpeg(_scene(24, 32, seed=13), 90, S444)
    _refused(tmp_path, _sof_replaced(base, 0xC0, lambda b: bytes([12]) + b[1:]), "12-bit")
    cmyk = _scene(24, 32, 4, seed=13)
    _check(tmp_path, _baseline_jpeg([cmyk[..., c] for c in range(4)], [(1, 1)] * 4, (24, 32),
                                    adobe=0))
    app14 = _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))  # transform 0: RGB
    no_jfif = base[:2] + base[4 + struct.unpack(">H", base[4:6])[0]:]  # drop APP0
    assert no_jfif[2:4] != b"\xff\xe0"
    rgb = _check(tmp_path, no_jfif[:2] + app14 + no_jfif[2:])
    assert not np.array_equal(rgb, imageio.decode_jpeg(base))


def test_interlaced_png_refused(tmp_path):
    """An interlaced (Adam7) PNG is read byte for byte (it was refused
    before): the same pixels as the non-interlaced file."""
    gray = _scene(16, 16, 1, seed=14)[..., None]
    got = _check(tmp_path, _png(gray, 8, 0, interlace=1))
    np.testing.assert_array_equal(got, gray[..., 0])


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_truncated_files_refused(tmp_path, kind):
    """A truncated PNG is refused by both; a JPEG cut in its scan is read
    as OpenCV reads it (libjpeg feeds zero bits, then leaves the rest of
    the scan's blocks at zero: flat 128)."""
    if kind == "jpeg":
        data = _jpeg(_scene(64, 64, seed=15), 90)
    else:
        data = _png(_scene(64, 64, 3, seed=15), 8, 2)
    for cut in (len(data) // 2, len(data) - 20):
        if kind == "jpeg":
            _check(tmp_path, data[:cut])
        else:
            _refused(tmp_path, data[:cut], "truncated")


def test_bad_crc_refused(tmp_path):
    data = bytearray(_png(_scene(16, 16, 3, seed=16), 8, 2))
    at = data.index(b"IDAT")
    n = struct.unpack(">I", data[at - 4:at])[0]
    data[at + 4 + n] ^= 0x01  # the CRC's first byte
    _refused(tmp_path, bytes(data), "IDAT has a bad CRC")


def test_corrupt_data_refused(tmp_path):
    """Image data that is not what the headers promise raises ValueError,
    never a crash: a deflate stream that does not inflate (its CRC right), a
    Huffman table with more codes than its lengths allow, a scan that names
    no table."""
    bad = _chunk(b"IDAT", b"\x78\x9c\xff\xff\xff")
    data = _png(_scene(8, 8, 1, seed=21)[..., None], 8, 0)
    at = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[at:at + 4])[0]
    _refused(tmp_path, data[:at] + bad + data[at + 12 + n:], "corrupt PNG image data")
    jpeg = bytearray(_jpeg(_scene(16, 16, seed=21), 90))
    at = jpeg.index(b"\xff\xc4") + 5  # the first DHT's code counts
    assert jpeg[at:at + 3] == b"\x00\x01\x05"  # libjpeg's standard luma DC table
    jpeg[at:at + 3] = b"\x03\x00\x03"  # as many codes, 3 of them of length 1
    _refused(tmp_path, bytes(jpeg), "bad Huffman table")
    jpeg = bytearray(_jpeg(_scene(16, 16, seed=21), 90))
    at = jpeg.index(b"\xff\xda") + 6  # the first scan component's table selectors
    jpeg[at] = 0x33
    _refused(tmp_path, bytes(jpeg), "Huffman tables")


@pytest.mark.parametrize("tag", ["sRGB", "gAMA"])
def test_gamma_tagged_color_png_refused(tmp_path, tag):
    """libpng converts a gamma-tagged color PNG to gray through its gamma
    tables (OpenCV's result differs from the plain luma); the port reads it
    byte for byte (it was refused before).  A gray PNG with the same tag is
    read too (no conversion applies)."""
    body = b"\0" if tag == "sRGB" else struct.pack(">I", 45455)
    rgb = _scene(20, 30, 3, seed=17)
    data = _png(rgb, 8, 2, extra=_chunk(tag.encode(), body))
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    got = _check(tmp_path, data)
    assert not np.array_equal(got, (9797 * r + 19234 * g + 3737 * b) >> 15)
    gray = _scene(20, 30, 1, seed=17)[..., None]
    _check(tmp_path, _png(gray, 8, 0, extra=_chunk(tag.encode(), body)))


def test_unknown_magic_and_missing_file(tmp_path):
    _refused(tmp_path, b"GIF89a" + bytes(32), "not a JPEG, PNG or binary netpbm")
    with pytest.raises(FileNotFoundError):
        imageio.decode_gray(tmp_path / "none.jpg")


def test_dispatch_is_on_magic_bytes_not_suffix(tmp_path):
    jpg = tmp_path / "really_a_jpeg.png"
    jpg.write_bytes(_jpeg(_scene(24, 40, seed=18)))
    np.testing.assert_array_equal(imageio.decode_gray(jpg), cv2.imread(str(jpg), 0))
    pgm = tmp_path / "frame.jpg"
    gray = _scene(24, 40, 1, seed=18)
    pgm.write_bytes(b"P5\n40 24\n255\n" + gray.tobytes())
    np.testing.assert_array_equal(imageio.decode_gray(pgm), gray)


def test_read_gray_resizes_decoded_images(tmp_path):
    """``read_gray``: the decode, then OpenCV's INTER_AREA, /255 — as the
    JAX package computes it."""
    for name, data, hw in (("a.jpg", _jpeg(_scene(480, 640, seed=19), 90), (240, 320)),
                           ("b.png", cv2.imencode(".png", _scene(75, 250, seed=19))[1].tobytes(),
                            (80, 256))):
        path = tmp_path / name
        path.write_bytes(data)
        want = cv2.resize(cv2.imread(str(path), 0), hw[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(read_gray(path, hw), want.astype(np.float32) / 255.0)


# -- the smoke's PNG writer --------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("form", ["plain", "adam7", "srgb", "adam7-srgb"])
@pytest.mark.parametrize("channels", [1, 3])
def test_smoke_png_writer_round_trips(tmp_path, channels, form):
    """``chip_smoke.write_png`` (each row's filter cycling through 0-4;
    Adam7 and an sRGB chunk as phase 15 writes its second drive) gives a PNG
    that OpenCV reads back exactly, in color and in gray."""
    img = _scene(23, 37, channels, seed=20)
    path = tmp_path / "w.png"
    _chip_smoke().write_png(path, img, adam7="adam7" in form, srgb="srgb" in form)
    if "adam7" not in form:
        assert _png_filters(path.read_bytes()) == {0, 1, 2, 3, 4}
    back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, img if channels == 1 else img[..., ::-1])
    np.testing.assert_array_equal(imageio.decode_gray(path), cv2.imread(str(path), 0))


# -- committed fixtures ----------------------------------------------------------------


def make_fixtures(out_dir: Path) -> dict:
    """Write the fixtures with OpenCV and return their manifest: per file
    its shape and the sha256 of OpenCV's uint8 gray decode.  Run once to
    make ``tests/data/torch_imageio`` (``python tests/test_torch_imageio.py``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {
        "gray_240x320_q96.jpg": _jpeg(_scene(240, 320, 1, seed=30, noise=4.0), 96),
        "ycc420_480x640_q90.jpg": _jpeg(_scene(480, 640, seed=31, noise=6.0), 90, S420),
        "ycc444_rst4_120x160_q90.jpg": _jpeg(_scene(120, 160, seed=32), 90, S444,
                                             (cv2.IMWRITE_JPEG_RST_INTERVAL, 4)),
        "ycc420_optimized_240x320_q85.jpg": _jpeg(_scene(240, 320, seed=33, noise=6.0), 85, S420,
                                                  (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
        "ycc420_odd_239x321_q90.jpg": _jpeg(_scene(239, 321, seed=34, noise=6.0), 90, S420),
        "exif6_120x160_q90.jpg": _with_exif(_jpeg(_scene(120, 160, seed=35), 90, S420), 6),
        "rgb_375x1242.png": cv2.imencode(".png", _scene(375, 1242, seed=36, noise=0.6))[1],
        "gray_240x320.png": cv2.imencode(".png", _scene(240, 320, 1, seed=37, noise=2.0))[1],
        "palette_120x160.png": _png(np.random.default_rng(38).integers(0, 16, (120, 160, 1)),
                                    4, 3, np.random.default_rng(39).integers(0, 256, (16, 3))),
        "rgba_120x160.png": cv2.imencode(".png", _scene(120, 160, 4, seed=40, noise=2.0))[1],
        "prog420_rst5_240x320_q85.jpg": _jpeg(_scene(240, 320, seed=41, noise=6.0), 85, S420,
                                              PROGRESSIVE + (cv2.IMWRITE_JPEG_RST_INTERVAL, 5)),
        "prog_gray_120x160_q90.jpg": _jpeg(_scene(120, 160, 1, seed=42, noise=4.0), 90, None,
                                           PROGRESSIVE),
        "cmyk_120x160_q90.jpg": _pillow_jpeg(_scene(120, 160, 4, seed=43, noise=4.0), "CMYK",
                                             quality=90),
        "rgbcoded_120x160_q90.jpg": _pillow_jpeg(_scene(120, 160, seed=44, noise=4.0), "RGB",
                                                 quality=90, keep_rgb=True),
        "adam7_rgb_120x160.png": _png(_scene(120, 160, seed=45, noise=2.0), 8, 2, interlace=1),
        "srgb_rgb_120x160.png": _png(_scene(120, 160, seed=46, noise=2.0), 8, 2, extra=SRGB),
        "palette_gama45455_120x160.png": _png(
            np.random.default_rng(47).integers(0, 200, (120, 160, 1)), 8, 3,
            np.random.default_rng(48).integers(0, 256, (200, 3)), extra=_gama(45455)),
        # arithmetic-coded (the system libjpeg's), lossless (written here),
        # files cut in a scan, and a PNG whose tEXt chunk has a bad CRC
        "arith_ycc420_480x640_q90.jpg": _arith_jpeg(_scene(480, 640, seed=31, noise=6.0), 90),
        "arith_prog420_rst4_240x320_q85.jpg": _arith_jpeg(_scene(240, 320, seed=41, noise=6.0),
                                                          85, progressive=True, restart=4),
        "arith_gray_240x320_q96.jpg": _arith_jpeg(_scene(240, 320, 1, seed=30, noise=4.0), 96,
                                                  hv="11", keep_dac=False),
        "lossless_gray_p1_240x320.jpg": _lossless_jpeg([_scene(240, 320, 1, seed=30, noise=4.0)],
                                                       [(1, 1)], (240, 320), predictor=1),
        "lossless_gray_p7_pt1_rst8_120x160.jpg": _lossless_jpeg(
            [_scene(120, 160, 1, seed=50, noise=4.0)], [(1, 1)], (120, 160), predictor=7, pt=1,
            restart_rows=8),
        "lossless_cmyk_120x160.jpg": _lossless_jpeg(
            [c for c in np.moveaxis(_scene(120, 160, 4, seed=51, noise=2.0), -1, 0)],
            [(2, 2), (1, 1), (1, 1), (2, 2)], (120, 160), predictor=4, adobe=0),
        "bad_text_crc_120x160.png": _png(_scene(120, 160, seed=52, noise=2.0), 8, 2,
                                         extra=_bad_crc(_chunk(b"tEXt", b"Comment\0cut"))),
    }
    # cut in a scan: the baseline and arithmetic 480x640 files at 55% of
    # their bytes, the progressive one inside its 6th scan (of 10: the
    # luma's refinement is lost, so libjpeg smooths)
    for name in ("ycc420_480x640_q90.jpg", "arith_ycc420_480x640_q90.jpg"):
        files["cut_" + name] = bytes(files[name])[:len(files[name]) * 55 // 100]
    prog = bytes(files["prog420_rst5_240x320_q85.jpg"])
    files["cut_prog420_rst5_240x320_q85.jpg"] = prog[:_prog_cut(prog)]
    manifest = {}
    for name, data in files.items():
        path = out_dir / name
        path.write_bytes(bytes(data))
        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        manifest[name] = {"shape": list(img.shape),
                          "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest


def _bad_crc(chunk: bytes) -> bytes:
    """A PNG chunk with the last bit of its CRC flipped."""
    return chunk[:-1] + bytes([chunk[-1] ^ 1])


def _prog_cut(prog: bytes) -> int:
    """Where the cut progressive fixture ends: 300 bytes into its 6th scan."""
    return sum(len(u) for u in _scan_units(prog)[:6]) + 300


def _manifest():
    return json.loads((FIXTURES / "manifest.json").read_text())


def test_fixtures_are_small_and_complete():
    manifest = _manifest()
    files = sorted(p.name for p in FIXTURES.iterdir() if p.name != "manifest.json")
    assert files == sorted(manifest) and len(files) == 27
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 3 << 19  # 1.5 MiB


# (empty before the fixtures are made: then the test above fails)
FIXTURE_NAMES = sorted(_manifest()) if (FIXTURES / "manifest.json").exists() else []


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_matches_manifest_through_opencv_and_the_port(name):
    entry = _manifest()[name]
    for img in (cv2.imread(str(FIXTURES / name), cv2.IMREAD_GRAYSCALE),
                imageio.decode_gray(FIXTURES / name)):
        assert list(img.shape) == entry["shape"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]


def test_fixtures_as_made_decode_alike(tmp_path):
    """Fixtures made afresh decode alike through OpenCV and the port, and
    to the manifest's shapes."""
    manifest = make_fixtures(tmp_path)
    for name, entry in manifest.items():
        img = imageio.decode_gray(tmp_path / name)
        assert list(img.shape) == entry["shape"] == _manifest()[name]["shape"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"]


# -- the build ------------------------------------------------------------------------


def test_library_is_named_by_a_hash_of_source_and_flags():
    path = _build._lib_path("imageio_host")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libimageio_host-")
    assert _build._lib_path("imageio_host", (*_build.GXX_FLAGS, "-O1")) != path
    assert "-ffast-math" not in _build.GXX_FLAGS


_BUILD_AND_DECODE = """
import hashlib, sys
from pathlib import Path
from ssp_torch.kernels import _build
_build.BUILD_DIR = Path(sys.argv[1])
from ssp_torch.data import imageio
img = imageio.decode_gray(sys.argv[2])
print(hashlib.sha256(img.tobytes()).hexdigest())
"""


def test_concurrent_builders_do_not_race(tmp_path):
    """Four processes build the decoder at once into an empty directory:
    each decodes correctly, and one library is left, with no temporaries."""
    name = "ycc420_480x640_q90.jpg"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_DECODE, str(tmp_path),
                               str(FIXTURES / name)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert {o.strip() for o, _ in outs} == {_manifest()[name]["sha256"]}
    left = sorted(p.name for p in tmp_path.iterdir())
    assert len(left) == 1 and left[0].startswith("libimageio_host-") and left[0].endswith(".so")


def test_compiler_failure_raises_with_its_output(tmp_path, monkeypatch):
    """No fallback: a source that does not compile makes the decode raise
    with g++'s message."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(_build.CSRC / "imageio_host.cpp", csrc)
    with open(csrc / "imageio_host.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for imageio_host.cpp") as err:
        imageio.decode_gray(FIXTURES / "gray_240x320.png")
    assert "this is not" in str(err.value)


if __name__ == "__main__":
    print(json.dumps(make_fixtures(FIXTURES), indent=1))
