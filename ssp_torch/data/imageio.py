"""Grayscale image decoding without OpenCV: JPEG, PNG and binary netpbm;
and two writers, :func:`write_png` and :func:`write_jpeg`.

:func:`decode_gray` returns what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
returns (OpenCV 5.0 on libjpeg-turbo 3.1, with its x86 SIMD code, and
libpng 1.6.58), byte for byte, and returns an image exactly when OpenCV
does (the JAX package reads images with OpenCV).  It dispatches on the
file's magic bytes, not on its suffix:

* ``FF D8 FF``: JPEG as libjpeg-turbo decodes it for OpenCV.  Huffman-coded
  baseline, extended sequential and progressive (SOF0-2); arithmetic-coded
  sequential and progressive (SOF9, SOF10: the QM decoder of T.81 Annex D,
  with DAC conditioning); lossless (SOF3: predictors 1-7, the point
  transform, samples of 2-8 bits, gray or CMYK); restart intervals; 1, 3 or
  4 components in libjpeg's colour space (gray, YCbCr, RGB, CMYK, YCCK) at
  any integral sampling factors.  The components that gray needs go
  through libjpeg-turbo's integer inverse DCT as its SIMD code computes it,
  its upsampling (the triangle filters for 2:1, replication otherwise and
  in a lossless file) and its colour conversion (RGB → Y in 16-bit fixed
  point; YCCK → CMYK through its tables), CMYK through OpenCV's CMYK →
  gray; then the EXIF orientation, as OpenCV applies it.  A damaged file is
  read as libjpeg reads it, with a warning: past the end of the file come
  fake EOI markers; a scan whose data runs out is decoded on zero bits to
  the end of its MCU and its later MCUs are skipped (their coefficients
  stay as they are: flat 128 in a sequential file) up to a restart; a bad
  Huffman code gives symbol 0; missing or misnumbered restart markers are
  resynchronised as ``jpeg_resync_to_restart`` does; bytes before a marker
  are skipped; a progressive file whose scans leave one of the first nine
  AC coefficients short of its last bit is smoothed (libjpeg-turbo's 5×5
  block smoothing); a sequential file's missing Huffman table 0 or 1 is the
  standard's; and what follows the data of a file of one scan is not read
  (OpenCV ignores what ``jpeg_finish_decompress`` finds there).  The
  decoder is C++ (``ssp_torch/csrc/imageio_host.cpp``);
* ``\x89PNG``: PNG, any bit depth and colour type, plain or interlaced
  (Adam7): the chunks are read and their CRCs checked here (an ancillary
  chunk with a bad CRC is dropped, as libpng drops it, and an IEND with a
  bad CRC still ends the file), the image data inflated with ``zlib``, and
  the C++ side unfilters the rows (each pass's own) and converts them to
  gray as libpng does for OpenCV (its 15-bit fixed-point luma, truncated),
  then the orientation of an ``eXIf`` chunk.  A color file (RGB, RGBA,
  palette) with a gamma goes through libpng's gamma tables as
  ``png_set_rgb_to_gray`` asks for them, fitted to ``cv2.imread``
  (:func:`_file_gamma`): ``sRGB`` is gamma 45455 and wins over ``gAMA``; a
  ``gAMA`` within 5% of 1 (its reciprocal too) changes nothing; ``cHRM``
  changes nothing (OpenCV sets the coefficients) and neither does an
  ``iCCP`` profile, sRGB or not (the ``gAMA`` beside it holds); a ``gAMA``
  of 1-4, whose reciprocal overflows libpng's fixed point, takes libpng's
  tables for an unset screen gamma; 16-bit samples are converted at 16
  bits, then cut to their high byte, the tables' shift 5 or ``sBIT``'s;
* ``P5``/``P6``: binary netpbm (:func:`ssp_torch.data.base.read_pnm`; color
  through OpenCV's 14-bit ``cvtColor`` weights, :func:`~ssp_torch.data.base.
  rgb_to_gray`, which is what OpenCV uses for these files).

A file that OpenCV does not read raises ``ValueError`` naming the file and
the form, and there is no fallback:

* 12-bit JPEG, and 12- to 16-bit lossless JPEG (messages "12-bit JPEG",
  "N-bit lossless JPEG"): OpenCV reads through libjpeg's 8-bit interface;
* arithmetic-coded lossless JPEG (SOF11) and hierarchical JPEG (SOF5-7,
  SOF13-15): libjpeg-turbo decodes neither;
* lossless JPEG in RGB, YCbCr or YCCK ("lossless JPEG in ..."): libjpeg
  takes no lossy colour conversion of a lossless file to gray;
* 2- or 5- to 10-component JPEG ("N-component JPEG"), fractional sampling
  factors, more than 10 blocks in an MCU, a height of 0 (set by a DNL
  marker), a side above 65500 or more than 2^30 pixels;
* damage that libjpeg treats as fatal ("corrupt JPEG: ...", "truncated
  JPEG: ..."): a bad length, index or table in DQT, DHT, DAC, DRI, SOF or
  SOS, a reserved marker, two frames, a scan before the frame, no scan at
  all (a file that ends before its first scan), a progressive or lossless
  scan whose Huffman table no DHT defined, bad progression parameters;
* a PNG that libpng or OpenCV does not read: truncated, a bad CRC on IHDR,
  PLTE or IDAT, an unknown critical chunk, image data that does not
  inflate.

The C++ library is built with the system ``g++`` at first use, into
``ssp_torch/_build`` (``ssp_torch.kernels._build``).  Its calls go through
``ctypes``, which releases the GIL, so decoding scales over the threads of
``ImageDataset.batches(workers=N)``.

:func:`write_png` writes a gray or BGR uint8 image as ``cv2.imwrite`` does
for a ``.png`` path: the channels swapped to the file's RGB order, 8 bits.
The bytes are its own (``zlib`` and ``struct`` alone, each row's filter
type cycling through 0-4), the pixels ``cv2.imread`` reads back are
``cv2.imwrite``'s.

:func:`write_jpeg` writes a uint8 gray image as ``cv2.imwrite`` does for a
``.jpg`` path, byte for byte: libjpeg-turbo's baseline file at the given
quality (C++ ``ssp_torch/csrc/jpeg_encode_host.cpp``, built like the
decoder).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

JPEG_MAGIC = b"\xff\xd8\xff"  # OpenCV's JPEG signature: SOI and a marker's first byte
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


def _encoder() -> ctypes.CDLL:
    from ssp_torch.kernels import _build

    lib = _build.load("jpeg_encode_host")
    if not getattr(lib, "_ssp_typed", False):
        i32, i64 = ctypes.c_int, ctypes.c_int64
        lib.ssp_jpeg_encode_gray.argtypes = [ctypes.c_void_p, i32, i32, i32, ctypes.c_void_p, i64]
        lib.ssp_jpeg_encode_gray.restype = i64
        lib.ssp_jpeg_encode_bound.argtypes = [i32, i32]
        lib.ssp_jpeg_encode_bound.restype = i64
        lib._ssp_typed = True
    return lib


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> Path:
    """uint8 [H, W] gray → the JPEG file ``cv2.imwrite(path, img,
    [cv2.IMWRITE_JPEG_QUALITY, quality])`` writes, byte for byte (module
    docstring); any other form is refused with ``ValueError``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"write_jpeg takes a uint8 [H, W] gray image, not {img.dtype} "
                         f"{img.shape}")
    if max(img.shape) > 65535:
        raise ValueError(f"a JPEG side is at most 65535 pixels, not {img.shape}")
    src = np.ascontiguousarray(img)
    lib = _encoder()
    out = np.empty(lib.ssp_jpeg_encode_bound(*src.shape), np.uint8)
    n = lib.ssp_jpeg_encode_gray(src.ctypes.data, src.shape[0], src.shape[1], int(quality),
                                 out.ctypes.data, out.size)
    if n < 0:
        raise RuntimeError("jpeg encoder: the output bound was too small")
    path = Path(path)
    path.write_bytes(out[:n].tobytes())
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
        pos = end
        if zlib.crc32(kind + body) != crc:
            # libpng's default: an ancillary chunk is dropped with a warning;
            # OpenCV takes IEND as it is; any other critical chunk is fatal
            if kind == b"IEND":
                break
            if kind[0] & 0x20:
                continue
            raise ValueError(f"{name}: PNG chunk {kind.decode('latin-1')} has a bad CRC")
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
