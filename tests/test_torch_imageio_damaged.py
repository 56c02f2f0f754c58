"""The port's image decoder (``ssp_torch.data.imageio``) against
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` on the JPEG and PNG forms that a
camera, an old scanner or an interrupted copy leaves: arithmetic-coded JPEG
(SOF9, SOF10; written by the system libjpeg through
``tests/torch_jpeg_writer.cpp``), lossless JPEG (SOF3; written here by
``_lossless_jpeg``), JPEG cut anywhere after its first scan header or
damaged in its entropy-coded data (flipped bits and bytes, inserted ``FF
xx`` pairs, deleted runs; ``hypothesis``, derandomised), marker-level
damage (extraneous bytes, missing or misnumbered restart markers, missing
Huffman tables), and PNG whose ancillary chunk or IEND has a bad CRC.

Bar: the port returns an image exactly when OpenCV does, and then every
byte is OpenCV's; where OpenCV returns None the port raises ValueError.  A
refusal of a file that OpenCV reads would pass only with a message naming a
form that the module docstring lists as refused (:data:`DOCUMENTED`); the
tests count such cases, and there are none.
"""

import collections
import struct
import zlib

import numpy as np
import pytest

from ssp_torch.data import imageio

cv2 = pytest.importorskip("cv2")
hyp = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from test_torch_imageio import (FIXTURES, S420, S444, PROGRESSIVE, _arith_jpeg, _chunk,  # noqa: E402
                                _drop_segments, _jpeg, _lossless_jpeg, _manifest, _png,
                                _samples, _scene, _segment)

# Refusal messages that name a form the module docstring lists as refused.
DOCUMENTED = ("12-bit JPEG", "bit lossless JPEG", "arithmetic-coded lossless JPEG",
              "hierarchical JPEG", "lossless JPEG in", "fractional sampling",
              "more than 10 blocks", "height of 0", "component JPEG")

def _same(tmp_path, data: bytes, name="img.jpg") -> str:
    """Decode ``data`` through OpenCV and the port and hold them to the bar;
    'read', 'refused' (both), or 'refused-documented' (OpenCV read it)."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    try:
        got = imageio.decode_gray(path)
    except ValueError as err:
        if want is None:
            return "refused"
        msg = str(err)
        assert any(form in msg for form in DOCUMENTED), f"refused what OpenCV reads: {msg}"
        return "refused-documented"
    assert want is not None, "the port read a file that OpenCV refuses"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "read"


def test_documented_forms_are_in_the_docstring():
    doc = " ".join(imageio.__doc__.split())
    for form in DOCUMENTED:
        assert form in doc, form


# -- arithmetic-coded JPEG ------------------------------------------------------------


@pytest.mark.parametrize("dac", ["default", "L2-U4-K3"])
@pytest.mark.parametrize("restart", [0, 4])
@pytest.mark.parametrize("sampling", ["gray", "420", "444"])
@pytest.mark.parametrize("progressive", [False, True], ids=["SOF9", "SOF10"])
def test_arithmetic_jpeg(tmp_path, progressive, sampling, restart, dac):
    """The system libjpeg's arithmetic coder, sequential and progressive
    (jpeg_simple_progression), gray, 4:2:0 and 4:4:4, with and without
    restarts; DAC conditioning at the defaults (the DAC segments dropped)
    or L = 2, U = 4, Kx = 3."""
    img = _scene(40, 56, 1 if sampling == "gray" else 3, seed=60 + restart)
    kw = {"keep_dac": False} if dac == "default" else {"dac": (2, 4, 3)}
    data = _arith_jpeg(img, 90, progressive, restart, "22" if sampling == "420" else "11", **kw)
    assert bytes([0xFF, 0xCA if progressive else 0xC9]) in data
    assert (b"\xff\xcc" in data) == (dac != "default")
    assert _same(tmp_path, data) == "read"


def test_arithmetic_jpeg_at_quality_100_and_odd_sizes(tmp_path):
    """Large coefficients (the magnitude contexts past Kx) and MCUs cut by
    the image's edge."""
    for hw, quality in (((17, 9), 100), ((1, 1), 90), ((239, 33), 100)):
        for progressive in (False, True):
            data = _arith_jpeg(_scene(*hw, seed=hw[0]), quality, progressive, 0, "22")
            assert _same(tmp_path, data) == "read"


def test_arithmetic_lossless_refused(tmp_path):
    """SOF11 (lossless, arithmetic): libjpeg-turbo refuses it, so does the port."""
    data = _lossless_jpeg([_scene(16, 24, 1, seed=61)], [(1, 1)], (16, 24), sof=0xCB)
    assert _same(tmp_path, data) == "refused"
    with pytest.raises(ValueError, match="arithmetic-coded lossless JPEG"):
        imageio.decode_jpeg(data)


# -- lossless JPEG -------------------------------------------------------------------


@pytest.mark.parametrize("components", [1, 3, 4])
@pytest.mark.parametrize("restart", [0, 2], ids=["no-restart", "restart-2-rows"])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpeg(tmp_path, predictor, pt, restart, components):
    """8-bit lossless JPEG: each predictor, point transform 0 and 2, a
    restart every 2 MCU rows or none; gray, three components (RGB: OpenCV's
    gray read of it is refused by libjpeg, which takes no lossy colour
    conversion of a lossless file, and by the port) and CMYK (read: OpenCV
    asks for CMYK and converts it itself), subsampled."""
    img = _scene(16, 24, components, seed=predictor * 10 + pt)
    planes = [img] if components == 1 else list(np.moveaxis(img, -1, 0))
    factors = {1: [(1, 1)], 3: [(1, 1)] * 3, 4: [(2, 2), (1, 1), (1, 1), (2, 1)]}[components]
    data = _lossless_jpeg(planes, factors, (16, 24), predictor, pt, restart)
    outcome = _same(tmp_path, data)
    assert outcome == ("refused" if components == 3 else "read")
    if components == 1:
        np.testing.assert_array_equal(imageio.decode_jpeg(data), (img >> pt) << pt)


@pytest.mark.parametrize("precision", [2, 5, 7, 12, 16])
def test_lossless_precision(tmp_path, precision):
    """Lossless samples of 2-8 bits are read as they are (OpenCV returns
    the raw values); 12- and 16-bit ones are refused by both."""
    img = (_scene(16, 24, 1, seed=precision).astype(np.int64) << 8) >> (16 - precision)
    data = _lossless_jpeg([img], [(1, 1)], (16, 24), 1, precision=precision)
    outcome = _same(tmp_path, data)
    assert outcome == ("read" if precision <= 8 else "refused")
    if precision <= 8:
        np.testing.assert_array_equal(imageio.decode_jpeg(data), img)


def test_lossless_colour_spaces(tmp_path):
    """Three components in every colour space libjpeg guesses (JFIF:
    YCbCr; Adobe 0: RGB; component ids 1-3 without markers: RGB, as
    libjpeg takes them for a lossless file) and YCCK are refused by both;
    CMYK with and without its Adobe marker is read."""
    img = _scene(16, 24, 4, seed=62)
    planes3, planes4 = list(np.moveaxis(img[..., :3], -1, 0)), list(np.moveaxis(img, -1, 0))
    for kw in ({"jfif": True}, {"adobe": 0}, {"adobe": 1}, {}):
        assert _same(tmp_path, _lossless_jpeg(planes3, [(1, 1)] * 3, (16, 24), 1, **kw)) == "refused"
    assert _same(tmp_path, _lossless_jpeg(planes4, [(1, 1)] * 4, (16, 24), 1, adobe=2)) == "refused"
    for kw in ({"adobe": 0}, {}):
        assert _same(tmp_path, _lossless_jpeg(planes4, [(1, 1)] * 4, (16, 24), 1, **kw)) == "read"


# -- cuts --------------------------------------------------------------------------------


def _scan_ends(data: bytes):
    """Offsets of each SOS marker past the first and of the EOI: where each
    scan's entropy-coded data ends (plus its table segments)."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        m = data[pos + 1]
        if m == 0xD9:
            return out + [pos]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            out.append(pos)
            while end + 1 < len(data) and not (data[end] == 0xFF and
                                               data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        pos = end
    return out


def _live_sources():
    """Files of the new forms written here, small, with restarts."""
    img, gray = _scene(48, 64, seed=63), _scene(48, 64, 1, seed=64)
    return {
        "arith-seq-420-rst2": _arith_jpeg(img, 90, False, 2, "22"),
        "arith-prog-420-rst2": _arith_jpeg(img, 90, True, 2, "22", dac=(1, 3, 8)),
        "arith-prog-gray": _arith_jpeg(gray, 90, True, 0, "11"),
        "baseline-444-rst2": _jpeg(img, 90, S444, (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)),
        "progressive-420-rst3": _jpeg(img, 85, S420, PROGRESSIVE + (cv2.IMWRITE_JPEG_RST_INTERVAL, 3)),
        "lossless-p5-rst": _lossless_jpeg([gray], [(1, 1)], (48, 64), 5, 1, 4),
        "lossless-cmyk": _lossless_jpeg(list(np.moveaxis(_scene(48, 64, 4, seed=65), -1, 0)),
                                        [(2, 2), (1, 1), (1, 1), (2, 2)], (48, 64), 6),
    }


_LIVE = {}


def live_sources():
    if not _LIVE:
        _LIVE.update(_live_sources())
    return _LIVE


JPEG_FIXTURES = [n for n in sorted(_manifest()) if n.endswith(".jpg")] \
    if (FIXTURES / "manifest.json").exists() else []
LIVE_NAMES = ["arith-seq-420-rst2", "arith-prog-420-rst2", "arith-prog-gray", "baseline-444-rst2",
              "progressive-420-rst3", "lossless-p5-rst", "lossless-cmyk"]


@pytest.mark.parametrize("name", JPEG_FIXTURES + LIVE_NAMES)
def test_cuts(tmp_path, name):
    """The file cut at 24 offsets drawn from a fixed seed between its first
    SOS marker and its end, and at the end of each scan: wherever OpenCV
    reads the cut file the port reads the same bytes (libjpeg's fake EOI,
    zero bits, skipped blocks, block smoothing of a progressive file);
    where it does not, the port refuses too."""
    data = (FIXTURES / name).read_bytes() if name.endswith(".jpg") else live_sources()[name]
    first = data.index(b"\xff\xda")
    rng = np.random.default_rng(sum(name.encode()))
    cuts = sorted(set(rng.integers(first, len(data), 24).tolist()) | set(_scan_ends(data)))
    outcomes = collections.Counter(_same(tmp_path, data[:cut]) for cut in cuts)
    print(name, dict(outcomes))
    assert outcomes["refused-documented"] == 0
    assert outcomes["read"] >= len(cuts) // 2


# -- damaged entropy-coded data -----------------------------------------------------------

DAMAGE_SOURCES = ["baseline-444-rst2", "progressive-420-rst3", "arith-seq-420-rst2",
                  "arith-prog-420-rst2", "lossless-p5-rst"]


def _damage(data: bytes, kind: str, at: float, value: int, n: int) -> bytes:
    """One edit in the entropy-coded data (after the first SOS header):
    ``flip`` n bits of a byte, ``byte`` set it to ``value``, ``ff-pair``
    insert FF ``value`` (a marker, a stuffed zero, fill), ``delete`` n
    bytes."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    i = start + int(at * (len(data) - 2 - start))
    d = bytearray(data)
    if kind == "flip":
        for b in range(n):
            d[i] ^= 1 << ((value + 3 * b) % 8)
    elif kind == "byte":
        d[i] = value
    elif kind == "ff-pair":
        d[i:i] = bytes([0xFF, value])
    else:
        del d[i:i + n * 4]
    return bytes(d)


@pytest.mark.parametrize("kind", ["flip", "byte", "ff-pair", "delete"])
def test_damaged_entropy_data(tmp_path_factory, kind):
    """Seeded damage in the entropy-coded data of baseline, progressive,
    arithmetic and lossless files with restarts (hypothesis, derandomised,
    60 cases a kind): the port never returns an image that differs from
    OpenCV's, never refuses what OpenCV reads, and reads all that OpenCV
    reads (bad Huffman codes, missing and misnumbered restart markers,
    extraneous bytes before a marker, data that runs out)."""
    sources = live_sources()
    work = tmp_path_factory.mktemp(kind)
    counts = collections.Counter()

    @hyp.settings(derandomize=True, max_examples=60, deadline=None, database=None,
                  suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(name=st.sampled_from(DAMAGE_SOURCES), at=st.floats(0, 1, exclude_max=True),
               value=st.integers(0, 255), n=st.integers(1, 3))
    def run(name, at, value, n):
        counts[_same(work, _damage(sources[name], kind, at, value, n))] += 1

    run()
    print(kind, dict(counts))
    assert sum(counts.values()) == 60 and counts["refused-documented"] == 0


# -- marker-level damage ------------------------------------------------------------------


def _with_restarts(data: bytes, edit) -> bytes:
    """``data`` with its RSTn markers (in the entropy-coded data) edited:
    ``edit(list of their offsets, bytearray)``."""
    d = bytearray(data)
    first = d.index(b"\xff\xda")
    rst = [i for i in range(first, len(d) - 1) if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]
    assert len(rst) >= 4
    edit(rst, d)
    return bytes(d)


def _delete_at(d, i, n):
    del d[i:i + n]


RESTART_EDITS = {
    "missing": lambda r, d: _delete_at(d, r[1], 2),
    "two-missing": lambda r, d: (_delete_at(d, r[3], 2), _delete_at(d, r[1], 2)),
    "renumbered-ahead": lambda r, d: d.__setitem__(r[1] + 1, 0xD0 + ((d[r[1] + 1] + 1) & 7)),
    "renumbered-far": lambda r, d: d.__setitem__(r[1] + 1, 0xD0 + ((d[r[1] + 1] + 4) & 7)),
    "renumbered-back": lambda r, d: d.__setitem__(r[2] + 1, 0xD0 + ((d[r[2] + 1] - 2) & 7)),
    "swapped": lambda r, d: (d.__setitem__(r[1] + 1, d[r[2] + 1]), d.__setitem__(r[2] + 1, 0xD1)),
    "extra": lambda r, d: d.__setitem__(slice(r[2], r[2]), bytes([0xFF, d[r[2] + 1]])),
    "junk-before": lambda r, d: d.__setitem__(slice(r[1], r[1]), b"\x12\x34\xff\x00\x56"),
    "fill": lambda r, d: d.__setitem__(slice(r[1], r[1]), b"\xff\xff\xff"),
    "reserved-marker": lambda r, d: d.__setitem__(slice(r[1], r[1]), b"\xff\x05"),
}


@pytest.mark.parametrize("source", ["baseline-444-rst2", "progressive-420-rst3", "arith-seq-420-rst2",
                                    "lossless-p5-rst"])
@pytest.mark.parametrize("edit", sorted(RESTART_EDITS))
def test_restart_markers(tmp_path, source, edit):
    """jdmarker.c's read_restart_marker and jpeg_resync_to_restart: a
    missing, misnumbered, swapped or extra restart marker, junk or fill
    before one, a reserved marker in its place."""
    assert _same(tmp_path, _with_restarts(live_sources()[source], RESTART_EDITS[edit])) != \
        "refused-documented"


def _insert_before(data: bytes, marker: int, extra: bytes) -> bytes:
    at = data.index(bytes([0xFF, marker]))
    return data[:at] + extra + data[at:]


def _header_cases():
    base = _jpeg(_scene(32, 48, seed=66), 90, S420)
    prog = _jpeg(_scene(32, 48, seed=66), 90, S420, PROGRESSIVE)
    arith = _arith_jpeg(_scene(32, 48, seed=66), 90, False, 0, "22")
    eoi = len(base) - 2
    sos = base.index(b"\xff\xda")
    return {
        "extraneous-bytes-before-DQT": (_insert_before(base, 0xDB, b"\x12\x34\x00"), "read"),
        "ff00-before-DQT": (_insert_before(base, 0xDB, b"\xff\x00"), "read"),
        "fill-before-SOF": (_insert_before(base, 0xC0, b"\xff\xff\xff"), "read"),
        "DNL-segment": (_insert_before(base, 0xDB, _segment(0xDC, b"\x00\x20")), "read"),
        "APP-of-length-1": (_insert_before(base, 0xDB, b"\xff\xe5\x00\x01"), "read"),
        "COM": (_insert_before(base, 0xDB, _segment(0xFE, b"made here")), "read"),
        "no-DHT-baseline": (_drop_segments(base, 0xC4), "read"),
        "no-DHT-progressive": (_drop_segments(prog, 0xC4), "refused"),
        "JPG-marker-C8": (_insert_before(base, 0xDB, _segment(0xC8, b"\x00")), "refused"),
        "DRI-of-length-5": (_insert_before(base, 0xDA, _segment(0xDD, b"\x00\x04\x00")), "refused"),
        "DQT-table-4": (_insert_before(base, 0xDA, _segment(0xDB, bytes([4]) + bytes(64))), "refused"),
        "SOF-twice": (_insert_before(base, 0xDA, base[base.index(b"\xff\xc0"):base.index(b"\xff\xc4")]),
                      "refused"),
        "EOI-before-SOS": (base[:sos] + b"\xff\xd9", "refused"),
        "no-marker-after-SOI": (base[:2] + b"\x00" + base[2:], "refused"),
        "cut-in-DHT": (base[:base.index(b"\xff\xc4") + 10], "refused"),
        "second-SOS-after-the-scan": (base[:eoi] + base[sos:], "read"),
        "bad-DQT-after-the-scan": (base[:eoi] + _segment(0xDB, bytes([5])) + b"\xff\xd9", "read"),
        "garbage-after-the-scan": (base[:eoi] + b"\x12\x34\xff\x05\xff\xd9", "read"),
        "DAC-L-above-U": (_insert_before(arith, 0xDA, _segment(0xCC, bytes([0, 0x12]))), "refused"),
        "DAC-K-0": (_insert_before(arith, 0xDA, _segment(0xCC, bytes([0x10, 0]))), "read"),
    }


_HEADERS = {}
HEADER_CASES = sorted(["APP-of-length-1", "COM", "DAC-K-0", "DAC-L-above-U", "DNL-segment",
                "DQT-table-4", "DRI-of-length-5", "EOI-before-SOS", "JPG-marker-C8",
                "SOF-twice", "bad-DQT-after-the-scan", "no-marker-after-SOI", "cut-in-DHT", "extraneous-bytes-before-DQT",
                "ff00-before-DQT", "fill-before-SOF", "garbage-after-the-scan", "no-DHT-baseline",
                "no-DHT-progressive", "second-SOS-after-the-scan"])


@pytest.mark.parametrize("case", HEADER_CASES)
def test_marker_level_damage(tmp_path, case):
    """What libjpeg skips with a warning (extraneous bytes before a marker,
    DNL, a bad length word of an APPn, damage after a one-scan file's data,
    which jpeg_finish_decompress meets and OpenCV ignores) is read; what it
    treats as fatal (a reserved marker, bad segment lengths and indices, two
    frames, no scan, a progressive file without its Huffman tables, DAC's
    L above U) is refused by both.  A sequential file without DHT takes the
    standard tables.  OpenCV takes a file for JPEG by FF D8 FF: a file with
    another byte after SOI is none of its formats."""
    if not _HEADERS:
        _HEADERS.update(_header_cases())
        assert sorted(_HEADERS) == HEADER_CASES
    data, want = _HEADERS[case]
    assert _same(tmp_path, data) == want


# -- block smoothing ------------------------------------------------------------------------


def test_smoothing_every_prefix_of_scans(tmp_path):
    """A progressive file kept to each prefix of its scans (EOI after), and
    each single scan left out: libjpeg-turbo's 5×5 estimate of the first
    nine AC coefficients (and of the DC where no AC is known), with the
    progression status latched before the last scan."""
    from test_torch_imageio import _scan_units

    for data in (_jpeg(_scene(56, 72, seed=67), 75, S420, PROGRESSIVE),
                 _jpeg(_scene(56, 72, 1, seed=68), 95, None, PROGRESSIVE),
                 _arith_jpeg(_scene(56, 72, seed=69), 80, True, 0, "22")):
        units = _scan_units(data)
        for k in range(2, len(units)):
            assert _same(tmp_path, b"".join(units[:k] + units[-1:])) != "refused-documented"
            assert _same(tmp_path, b"".join(units[:k - 1] + units[k:])) != "refused-documented"


# -- PNG with a bad CRC ----------------------------------------------------------------------

ANCILLARY = {
    "tEXt": b"Comment\0made here",
    "gAMA": struct.pack(">I", 220000),
    "sRGB": b"\0",
    "sBIT": bytes([5, 5, 5]),
    "cHRM": struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000),
    "iCCP": b"p\0\0" + zlib.compress(b"not a profile"),
    "eXIf": b"MM\0*\0\0\0\x08\0\x01\x01\x12\0\x03\0\0\0\x01\0\x06\0\0\0\0\0\0",
}


@pytest.mark.parametrize("ctype,depth,channels", [(2, 8, 3), (2, 16, 3), (3, 8, 1)],
                         ids=["rgb8", "rgb16", "palette"])
@pytest.mark.parametrize("kind", sorted(ANCILLARY))
def test_png_ancillary_chunk_with_bad_crc(tmp_path, kind, ctype, depth, channels):
    """libpng's default CRC action for an ancillary chunk: a warning, and
    the chunk is dropped (a dropped gAMA, sRGB, sBIT or eXIf counts as
    absent; a good gAMA beside it holds)."""
    samples, palette = _samples(ctype, depth, channels, (24, 32), 70 + ctype + depth)
    bad = _chunk(kind.encode(), ANCILLARY[kind])
    bad = bad[:-1] + bytes([bad[-1] ^ 1])
    good = _chunk(b"gAMA", struct.pack(">I", 45455))
    for extra in (bad, good + bad, bad + good):
        assert _same(tmp_path, _png(samples, depth, ctype, palette, extra=extra), "c.png") == "read"


@pytest.mark.parametrize("kind", ["IHDR", "PLTE", "IDAT", "IEND"])
def test_png_critical_chunk_with_bad_crc(tmp_path, kind):
    """A bad CRC on IHDR, PLTE or IDAT is refused by both; on IEND, which
    OpenCV meets after the image, it is read."""
    samples, palette = _samples(3, 8, 1, (24, 32), 71)
    data = bytearray(_png(samples, 8, 3, palette))
    at = data.index(kind.encode())
    n = struct.unpack(">I", data[at - 4:at])[0]
    data[at + 4 + n] ^= 1
    assert _same(tmp_path, bytes(data), "c.png") == ("read" if kind == "IEND" else "refused")


# -- held against the JAX package ----------------------------------------------------------

COCO_FORMS = ["arith_ycc420_480x640_q90.jpg", "arith_prog420_rst4_240x320_q85.jpg",
              "arith_gray_240x320_q96.jpg", "lossless_gray_p1_240x320.jpg",
              "lossless_gray_p7_pt1_rst8_120x160.jpg", "lossless_cmyk_120x160.jpg",
              "cut_ycc420_480x640_q90.jpg", "cut_prog420_rst5_240x320_q85.jpg",
              "cut_arith_ycc420_480x640_q90.jpg", "bad_text_crc_120x160.png"]


def test_coco_reader_equals_the_jax_reader(tmp_path):
    """A COCO tree holding one file of each new form (and the cut baseline
    file) with pseudo-labels: the port's CocoDataset gives the JAX
    package's images (OpenCV's decode, INTER_AREA to 240×320) and points
    sample for sample, and its loader yields batches over it on 4 threads."""
    from ssp_torch.data.coco import CocoDataset

    j_coco = pytest.importorskip("ssp.data.coco")
    images, labels = tmp_path / "COCO" / "train2017", tmp_path / "labels" / "train2017"
    images.mkdir(parents=True)
    labels.mkdir(parents=True)
    rng = np.random.default_rng(72)
    for i, name in enumerate(COCO_FORMS):
        stem = f"{i + 1:012d}"
        (images / f"{stem}{name[-4:]}").write_bytes((FIXTURES / name).read_bytes())
        np.savez_compressed(labels / f"{stem}.npz",
                            pts=rng.uniform(0, 200, (int(rng.integers(5, 50)), 3)).astype(np.float32))
    kw = dict(root=tmp_path / "COCO", labels=tmp_path / "labels",
              preprocessing={"resize": [240, 320]})
    port, jax = CocoDataset(**kw), j_coco.CocoDataset(**kw)
    assert len(port) == len(jax) == len(COCO_FORMS)
    for i in range(len(port)):
        a, b = port[i], jax[i]
        assert a["name"] == b["name"]
        assert a["image"].dtype == np.float32 and a["image"].shape == (240, 320)
        np.testing.assert_array_equal(a["image"], np.asarray(b["image"]))
        np.testing.assert_array_equal(a["points"], np.asarray(b["points"]))
        np.testing.assert_array_equal(a["points_valid"], np.asarray(b["points_valid"]))
    batch = next(port.batches(16, workers=4))
    assert batch["image"].shape == (16, 240, 320) and np.isfinite(batch["image"]).all()

