"""Grayscale image decoding without OpenCV: JPEG, PNG and binary netpbm;
and a PNG writer (:func:`write_png`).

:func:`decode_gray` returns what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
returns (OpenCV 5.0 on libjpeg-turbo 3.1 and libpng 1.6.58), byte for byte,
for the forms it reads (the JAX package reads images with OpenCV).  It
dispatches on the file's magic bytes, not on its suffix:

* ``FF D8``: JPEG, 8-bit, Huffman-coded, baseline, extended sequential or
  progressive (spectral selection and successive approximation, restart
  intervals); gray, YCbCr, RGB-coded (Adobe transform 0, or component ids
  R, G, B), CMYK (Adobe transform 0 or no Adobe marker) and YCCK (transform
  2); any integral sampling factors, luma subsampled against chroma too.
  The components that gray needs go through libjpeg's integer inverse DCT
  (Y alone of YCbCr; all of the others), libjpeg-turbo's upsampling (the
  triangle filters for 2:1, replication otherwise) and its colour
  conversion (RGB → Y in 16-bit fixed point; YCCK → CMYK through its
  tables), CMYK through OpenCV's CMYK → gray; then the EXIF orientation,
  as OpenCV applies it.  The decoder is C++
  (``ssp_torch/csrc/imageio_host.cpp``);
* ``\x89PNG``: PNG, any bit depth and colour type, plain or interlaced
  (Adam7): the chunks are read and their CRCs checked here, the image data
  inflated with ``zlib``, and the C++ side unfilters the rows (each pass's
  own) and converts them to gray as libpng does for OpenCV (its 15-bit
  fixed-point luma, truncated), then the orientation of an ``eXIf`` chunk.
  A color file (RGB, RGBA, palette) with a gamma goes through libpng's gamma
  tables as ``png_set_rgb_to_gray`` asks for them, fitted to ``cv2.imread``
  (:func:`_file_gamma`): ``sRGB`` is gamma 45455 and wins over ``gAMA``;
  a ``gAMA`` within 5% of 1 (its reciprocal too) changes nothing; ``cHRM``
  changes nothing (OpenCV sets the coefficients) and neither does an
  ``iCCP`` profile, sRGB or not (the ``gAMA`` beside it holds); 16-bit
  samples are converted at 16 bits, then cut to their high byte, the tables'
  shift 5 or ``sBIT``'s;
* ``P5``/``P6``: binary netpbm (:func:`ssp_torch.data.base.read_pnm`; color
  through OpenCV's 14-bit ``cvtColor`` weights, :func:`~ssp_torch.data.base.
  rgb_to_gray`, which is what OpenCV uses for these files).

A form the decoder does not reproduce raises ``ValueError`` naming the file
and the form, and there is no fallback:

* lossless (SOF3), arithmetic-coded (SOF9-11, 13-15) and 12-bit JPEG, and a
  DNL marker: neither OpenCV nor Pillow writes them, so OpenCV's result for
  them is not tested;
* hierarchical JPEG (SOF5-7): libjpeg does not decode it either;
* progressive JPEG whose scans leave one of the first nine AC coefficients
  of a needed component short of its last bit: libjpeg then smooths the
  blocks (``jdcoefct.c``), an estimate not reproduced here;
* sampling factors libjpeg refuses (fractional, more than 10 blocks in an
  MCU), where ``cv2.imread`` returns None;
* a color PNG with a ``gAMA`` of 1-4, whose reciprocal overflows libpng's
  fixed point;
* a truncated or corrupt file.

The C++ library is built with the system ``g++`` at first use, into
``ssp_torch/_build`` (``ssp_torch.kernels._build``).  Its calls go through
``ctypes``, which releases the GIL, so decoding scales over the threads of
``ImageDataset.batches(workers=N)``.

:func:`write_png` writes a gray or BGR uint8 image as ``cv2.imwrite`` does
for a ``.png`` path: the channels swapped to the file's RGB order, 8 bits.
The bytes are its own (``zlib`` and ``struct`` alone, each row's filter
type cycling through 0-4), the pixels ``cv2.imread`` reads back are
``cv2.imwrite``'s.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

JPEG_MAGIC = b"\xff\xd8"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
PNM_MAGICS = (b"P5", b"P6")

# PNG colour type → (channels, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# libpng's fixed-point gamma of an sRGB chunk (PNG_GAMMA_sRGB_INVERSE)
_SRGB_GAMMA = 45455
# sBIT's length by colour type
_SBIT_LEN = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}
_MSG = 256


def _lib() -> ctypes.CDLL:
    from ssp_torch.kernels import _build

    lib = _build.load("imageio_host")
    if not getattr(lib, "_ssp_typed", False):
        buf, size, msg = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
        lib.ssp_jpeg_info.argtypes = [buf, size, ctypes.POINTER(ctypes.c_int), msg, ctypes.c_int]
        lib.ssp_jpeg_gray.argtypes = [buf, size, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      msg, ctypes.c_int]
        lib.ssp_exif_orientation.argtypes = [buf, size]
        i32 = ctypes.c_int
        lib.ssp_png_gray.argtypes = [buf, size, i32, i32, i32, i32, i32, buf, i32, i32, i32,
                                     ctypes.c_void_p, msg, i32]
        for fn in (lib.ssp_jpeg_info, lib.ssp_jpeg_gray, lib.ssp_exif_orientation,
                   lib.ssp_png_gray):
            fn.restype = ctypes.c_int
        lib._ssp_typed = True
    return lib


def png_chunk(kind: bytes, body: bytes) -> bytes:
    """One PNG chunk: length, type, body, CRC."""
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def filter_rows(px: np.ndarray, ch: int) -> bytes:
    """uint8 rows [h, w * ch] (``ch`` bytes a pixel) → PNG's filtered rows,
    row y with type y % 5 (None, Sub, Up, Average, Paeth)."""
    px = px.astype(np.int16)
    pad = np.zeros(ch, np.int16)
    prev = np.zeros(px.shape[1], np.int16)
    rows = []
    for y, cur in enumerate(px):
        a = np.concatenate([pad, cur[:-ch]])  # left
        c = np.concatenate([pad, prev[:-ch]])  # up-left
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = (0, a, prev, (a + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c)))[y % 5]
        rows.append(bytes([y % 5]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(rows)


def write_png(path, img: np.ndarray) -> Path:
    """uint8 [H, W] gray or [H, W, 3] BGR → an 8-bit PNG at ``path`` (RGB on
    disk, as ``cv2.imwrite`` writes it).  Row y is filtered with type y % 5
    (:func:`filter_rows`), so that reading it back takes every filter."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], not {img.dtype} "
                         f"{img.shape}")
    img = np.ascontiguousarray(img if img.ndim == 2 else img[..., ::-1])  # BGR → RGB
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    path = Path(path)
    path.write_bytes(
        PNG_MAGIC
        + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0))
        + png_chunk(b"IDAT", zlib.compress(filter_rows(img.reshape(h, w * ch), ch), 6))
        + png_chunk(b"IEND", b""))
    return path


def decode_gray(path) -> np.ndarray:
    """The image at ``path`` as uint8 [H, W], as ``cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)`` gives it.  ``FileNotFoundError`` if it does not
    exist; ``ValueError`` for a form that is not read (module docstring)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"unreadable image: {path}")
    data = path.read_bytes()
    if data.startswith(JPEG_MAGIC):
        return decode_jpeg(data, path)
    if data.startswith(PNG_MAGIC):
        return decode_png(data, path)
    if data[:2] in PNM_MAGICS:
        from ssp_torch.data.base import read_pnm, rgb_to_gray

        img = read_pnm(path)
        return rgb_to_gray(img) if img.ndim == 3 else img
    raise ValueError(f"{path}: not a JPEG, PNG or binary netpbm (P5/P6) file")


def decode_jpeg(data: bytes, name="<bytes>") -> np.ndarray:
    """A JPEG held in memory → uint8 [H, W] (module docstring)."""
    lib = _lib()
    msg = ctypes.create_string_buffer(_MSG)
    hw = (ctypes.c_int * 2)()
    if lib.ssp_jpeg_info(data, len(data), hw, msg, _MSG) != 0:
        raise ValueError(f"{name}: {msg.value.decode()}")
    out = np.empty((hw[0], hw[1]), np.uint8)
    if lib.ssp_jpeg_gray(data, len(data), out.ctypes.data, hw[0], hw[1], msg, _MSG) != 0:
        raise ValueError(f"{name}: {msg.value.decode()}")
    return out


def _file_gamma(chunks, ctype: int, depth: int, name):
    """(gamma, sig_bit) as libpng 1.6.58 takes them for ``png_set_rgb_to_gray``
    (fitted to ``cv2.imread``): the chunks before PLTE and IDAT count (later
    ones are out of place); a valid ``sRGB`` gives 45455 whatever the
    ``gAMA``; else the first ``gAMA`` of 4 bytes, 0 and values past 2^31 − 1
    being invalid; ``iCCP`` and ``cHRM`` change nothing.  sig_bit is the
    largest colour sample of a valid ``sBIT`` (it sets the 16-bit tables'
    shift)."""
    gamma, srgb, sig_bit = 0, False, 0
    for kind, body in chunks:
        if kind == b"sRGB" and len(body) == 1 and body[0] <= 3:
            srgb = True
        elif kind == b"gAMA" and len(body) == 4 and not gamma:
            value = struct.unpack(">I", body)[0]
            gamma = value if value < 1 << 31 else 0
        elif kind == b"sBIT" and len(body) == _SBIT_LEN[ctype]:
            top = 8 if ctype == 3 else depth
            if all(0 < b <= top for b in body):
                sig_bit = max(body[:3]) if ctype in (2, 3, 6) else body[0]
    if srgb:
        gamma = _SRGB_GAMMA
    if 0 < gamma < 5 and ctype in (2, 3, 6):
        raise ValueError(f"{name}: color PNG with a gAMA of {gamma} (below 5: its reciprocal "
                         f"overflows libpng's fixed point) is not supported")
    return gamma, sig_bit


def decode_png(data: bytes, name="<bytes>") -> np.ndarray:
    """A PNG held in memory → uint8 [H, W] (module docstring)."""
    ihdr, plte, exif = None, b"", None
    idat, colour_chunks = [], []
    pos, n = len(PNG_MAGIC), len(data)
    while True:
        if pos + 8 > n:
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > n:
            raise ValueError(f"{name}: truncated PNG (chunk {kind!r} past the end)")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: PNG chunk {kind.decode('latin-1')} has a bad CRC")
        pos = end
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: corrupt PNG (IHDR of {len(body)} bytes)")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            exif = body
        elif kind in (b"gAMA", b"sRGB", b"sBIT"):
            if not plte and not idat:
                colour_chunks.append((kind, body))
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # critical, and unknown
            raise ValueError(f"{name}: PNG with an unknown critical chunk {kind!r}")
    if ihdr is None:
        raise ValueError(f"{name}: corrupt PNG (no IHDR chunk)")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1] or comp or filt:
        raise ValueError(f"{name}: corrupt PNG (colour type {ctype}, bit depth {depth})")
    if interlace > 1:
        raise ValueError(f"{name}: corrupt PNG (interlace method {interlace})")
    if not 0 < w * h <= 1 << 30:
        raise ValueError(f"{name}: PNG of {h}x{w} pixels is not read")
    if ctype == 3 and not plte:
        raise ValueError(f"{name}: corrupt PNG (palette image without PLTE)")
    gamma, sig_bit = _file_gamma(colour_chunks, ctype, depth, name)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    if not inflate.eof:
        raise ValueError(f"{name}: truncated PNG (image data ends early)")
    palette = plte[:768].ljust(768, b"\0")
    lib = _lib()
    orientation = lib.ssp_exif_orientation(exif, len(exif)) if exif else 1
    out = np.empty((w, h) if orientation >= 5 else (h, w), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    if lib.ssp_png_gray(raw, len(raw), h, w, depth, ctype, interlace, palette, gamma, sig_bit,
                        orientation, out.ctypes.data, msg, _MSG) != 0:
        raise ValueError(f"{name}: {msg.value.decode()}")
    return out
