"""The port's image readers against ``cv2.imread`` (OpenCV 5.0.0, its
bundled libjpeg-turbo 3.1.2), byte for byte, no tolerance:

* the JPEG decoder (``native/jpeg.c`` + ``data/jpeg.py``) on files written
  here by OpenCV (the five sampling factors it writes, qualities 5-100,
  sizes 1×1 to 427×640, baseline and progressive, optimised Huffman
  tables, restart intervals), grey files, CMYK files written by PIL, EXIF
  orientations 1-8 in either byte order, and files cut short (baseline,
  and progressive in its first scan and later: libjpeg's block smoothing);
* arithmetic-coded files (``tests/data/torch_jpeg_arith``, written by
  libjpeg-turbo 2.1.5 through ``write_arith.c`` there): sequential and
  progressive, grey and colour, restarts, DAC conditioning, cut short and
  damaged; lossless arithmetic and hierarchical files refused as cv2
  refuses them;
* the committed fixtures (``tests/data/torch_jpeg``) against the sha256 of
  ``cv2.imread``'s pixels in their manifest, which also holds the decoder
  to libjpeg-turbo where OpenCV is absent (``chip_smoke.py``);
* ``image_io.imread``'s dispatch on the file's signature (a PNG named
  ``.jpg``), its refusal of other files, and 8 threads against one;
* the PNG row unfilter in C against its numpy plain version.

``python -m tests.test_torch_jpeg --write-fixtures`` writes the fixtures
and their manifest anew (OpenCV and PIL write them), ``--write-arith-fixtures``
the arithmetic-coded ones (the system's libjpeg); ``--fuzz N`` prints
how N randomly damaged files read in the port against ``cv2.imread``;
``--time`` prints the one-thread decode of the 640×427 fixture beside
``cv2.imdecode``'s and the PNG unfilter at 1024×2048 in C beside numpy.
"""
import collections
import hashlib
import io
import json
import os
import struct
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from cvpytorch_tpu_torch import native
from cvpytorch_tpu_torch.data import image_io, jpeg, png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
MANIFEST = os.path.join(FIXTURES, "manifest.json")
SAMPLING = {"411": 0x411111, "420": 0x221111, "422": 0x211111, "440": 0x121111, "444": 0x111111}
SIZES = [(1, 1), (7, 13), (17, 33), (427, 640)]  # (H, W)
QUALITIES = [5, 30, 75, 95, 100]


def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A BGR frame with gradients, discs, edges and some noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x * 200 / max(w, 1), y * 220 / max(h, 1), (x + y) * 90 / max(h + w, 1)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.3) * max(h, w)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def cv2_read(tmp_path, data: bytes, name: str = "x.jpg", flags=cv2.IMREAD_COLOR):
    path = tmp_path / name
    path.write_bytes(data)
    return cv2.imread(str(path), flags)


def encode(img, quality=75, sampling="420", progressive=0, optimize=0, restart=0) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, progressive, cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def with_exif(data: bytes, orientation: int, order: str) -> bytes:
    """``data`` with an APP1 EXIF segment holding IFD0's orientation tag."""
    bo = b"II" if order == "<" else b"MM"
    tiff = (bo + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(order + "I", 0))
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def cmyk_jpeg(img: np.ndarray, quality: int, subsampling: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).convert("CMYK").save(
        buf, "JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


# ---- the committed fixtures ----

def fixture_files() -> dict:
    """name → (bytes, how it was written)."""
    out = {}
    for name, (h, w), kw in (("coco_640x427_420.jpg", (427, 640), {}),
                             ("coco_427x640_420.jpg", (640, 427), {})):
        out[name] = (encode(scene(h, w, 1 + len(out)), quality=80, **kw),
                     f"cv2.imencode, {w}x{h}, 4:2:0, baseline, quality 80")
    out["progressive_480x640.jpg"] = (
        encode(scene(640, 480, 3), quality=80, progressive=1),
        "cv2.imencode, 480x640, 4:2:0, progressive, quality 80")
    out["444_restart_640x480.jpg"] = (
        encode(scene(480, 640, 4), quality=70, sampling="444", restart=4),
        "cv2.imencode, 640x480, 4:4:4, baseline, restart interval 4 MCU rows, quality 70")
    out["grey_320x240.jpg"] = (
        encode(cv2.cvtColor(scene(240, 320, 5), cv2.COLOR_BGR2GRAY), quality=85),
        "cv2.imencode of a grey frame, 320x240, quality 85")
    out["cmyk_200x150.jpg"] = (cmyk_jpeg(scene(150, 200, 6), 85, 0),
                               "PIL, CMYK (Adobe APP14), 200x150, 4:4:4, quality 85")
    out["exif6_160x120.jpg"] = (
        with_exif(encode(scene(120, 160, 7), quality=85), 6, "<"),
        "cv2.imencode, 160x120, 4:2:0, quality 85, an EXIF APP1 (little-endian) "
        "with orientation 6 spliced in after SOI")
    return out


def write_fixtures() -> None:
    import tempfile

    os.makedirs(FIXTURES, exist_ok=True)
    manifest = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (data, how) in fixture_files().items():
            with open(os.path.join(FIXTURES, name), "wb") as f:
                f.write(data)
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            manifest[name] = {"written_by": how, "bytes": len(data),
                              "cv2_imread_shape": list(img.shape),
                              "cv2_imread_sha256": digest(img)}
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(manifest()) if os.path.exists(MANIFEST) else [])
def test_fixture_equals_manifest_and_cv2(name):
    path = os.path.join(FIXTURES, name)
    entry = manifest()[name]
    got = image_io.imread(path)
    assert list(got.shape) == entry["cv2_imread_shape"]
    assert digest(got) == entry["cv2_imread_sha256"]
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))


def test_fixtures_stay_small():
    assert len(manifest()) == 7
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES))
    assert total <= 300 * 1024, total


# ---- OpenCV-written files across the encoder's options ----

@pytest.mark.parametrize("mode", ["baseline", "optimized", "progressive", "restart"])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_decoder_equals_cv2(tmp_path, sampling, mode):
    kw = {"baseline": {}, "optimized": {"optimize": 1}, "progressive": {"progressive": 1},
          "restart": {"restart": 1}}[mode]
    for i, (h, w) in enumerate(SIZES):
        img = scene(h, w, i)
        for q in QUALITIES if h < 100 else QUALITIES[::2]:
            data = encode(img, quality=q, sampling=sampling, **kw)
            want = cv2_read(tmp_path, data)
            got = jpeg.decode(data)
            assert got.shape == want.shape
            assert np.array_equal(got, want), (h, w, q)


@pytest.mark.parametrize("progressive", [0, 1])
def test_grey_files_and_grayscale_reads(tmp_path, progressive):
    grey = cv2.cvtColor(scene(37, 61, 2), cv2.COLOR_BGR2GRAY)
    data = encode(grey, quality=80, progressive=progressive)
    np.testing.assert_array_equal(jpeg.decode(data), cv2_read(tmp_path, data))
    np.testing.assert_array_equal(jpeg.decode(data, grayscale=True),
                                  cv2_read(tmp_path, data, flags=cv2.IMREAD_GRAYSCALE))
    colour = encode(scene(37, 61, 3), quality=80, progressive=progressive)
    np.testing.assert_array_equal(jpeg.decode(colour, grayscale=True),
                                  cv2_read(tmp_path, colour, flags=cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_cmyk_files_written_by_pil(tmp_path, subsampling):
    for q in (40, 90):
        data = cmyk_jpeg(scene(45, 70, 4), q, subsampling)
        np.testing.assert_array_equal(jpeg.decode(data), cv2_read(tmp_path, data))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation, order):
    data = with_exif(encode(scene(23, 41, 5), quality=85), orientation, order)
    want = cv2_read(tmp_path, data)
    assert want.shape[:2] == ((41, 23) if orientation >= 5 else (23, 41))
    np.testing.assert_array_equal(jpeg.decode(data), want)
    np.testing.assert_array_equal(jpeg.decode(data, grayscale=True),
                                  cv2_read(tmp_path, data, flags=cv2.IMREAD_GRAYSCALE))


def scan_starts(data: bytes) -> list:
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("progressive", [0, 1])
def test_truncated_files(tmp_path, progressive, sampling):
    """Cut inside scans (for a progressive file in its first, DC scan too,
    where libjpeg interpolates the DC values) and in the last scan; the
    narrow frame has components two blocks wide."""
    for h, w in ((60, 90), (40, 12)):
        data = encode(scene(h, w, 6), quality=85, progressive=progressive, sampling=sampling)
        starts = scan_starts(data)
        cuts = [starts[0] + 40, (starts[0] + len(data)) // 2, len(data) - 30]
        if progressive:
            cuts += [(starts[0] + starts[1]) // 2, starts[-1] + 40]
        decoded = 0
        for cut in cuts:
            want = cv2_read(tmp_path, data[:cut])
            decoded += want is not None
            if want is None:  # the cut fell in a marker segment: cv2 reads nothing
                with pytest.raises(ValueError):
                    jpeg.decode(data[:cut])
            else:
                assert np.array_equal(jpeg.decode(data[:cut]), want), (h, w, cut)
        assert decoded >= len(cuts) - 2


# ---- damaged files ----

def fuzz(n: int, seed: int) -> collections.Counter:
    """``n`` files damaged by 1-7 random bytes (a third also cut short),
    from Huffman-coded base files and arithmetic-coded fixtures, each read by ``image_io.decode`` and by ``cv2.imread`` → counts of
    equal, both refused, port reads / cv2 refuses, cv2 reads / port
    refuses, and differ."""
    rng = np.random.RandomState(seed)
    kinds = [("420", 0), ("444", 1), ("422", 1), ("411", 0), ("440", 1)]
    base = [encode(scene(37 + 5 * i, 53 + 7 * i, i), quality=60 + 7 * i, sampling=k,
                   progressive=p, restart=i % 2) for i, (k, p) in enumerate(kinds)]
    base += [arith_files()[name] for name in ARITH_FUZZ_BASE]
    out = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "damaged.jpg")
        for i in range(n):
            data = bytearray(base[i % len(base)])
            for _ in range(rng.randint(1, 8)):
                data[rng.randint(2, len(data))] = rng.randint(0, 256)
            if rng.rand() < 0.3:
                data = data[:rng.randint(2, len(data))]
            with open(path, "wb") as f:
                f.write(data)
            want = cv2.imread(path, cv2.IMREAD_COLOR)
            try:
                got = image_io.decode(bytes(data))
            except ValueError:
                got = None
            if got is None or want is None:
                out[{(True, True): "both refuse", (False, True): "port reads, cv2 refuses",
                     (True, False): "cv2 reads, port refuses"}[got is None, want is None]] += 1
            else:
                out["equal" if np.array_equal(got, want) else "differ"] += 1
    return out


def test_damaged_files_read_as_cv2_or_not_at_all():
    """No crash, no other pixels than cv2's, nothing cv2 reads is refused
    and nothing cv2 refuses is read (``--fuzz 1500`` finds none either)."""
    counts = fuzz(150, 0)
    assert counts["differ"] == 0 and counts["cv2 reads, port refuses"] == 0, counts
    assert counts["port reads, cv2 refuses"] == 0, counts
    assert counts["equal"] > 50


DAMAGED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg_damaged")


@pytest.mark.parametrize("name", sorted(os.listdir(DAMAGED)))
def test_damaged_fixtures_read_as_cv2(name):
    """Damaged files the fuzz found, committed.  ``progressive_444_restart_
    fuzz8000_seed0.jpg`` (``--fuzz 8000`` before arithmetic base files
    joined it, seed 0, file 4431: a 4:4:4 progressive file with a restart
    every MCU, cut short, one byte changed in a scan and the first value of
    an AC table turned from EOB into 0x94, so its blocks run past their
    segments): libjpeg moves its last good iMCU row, which decides the
    rows block smoothing treats as complete, only where the data sufficed
    before the MCU, ahead of the restart the MCU begins with."""
    path = os.path.join(DAMAGED, name)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(image_io.imread(path), want)
    np.testing.assert_array_equal(image_io.imread(path, grayscale=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def segment(marker: int, body: bytes) -> bytes:
    return b"\xff" + bytes([marker]) + struct.pack(">H", len(body) + 2) + body


def markers(data: bytes):
    """(offset, marker, length field) of each segment before the first scan."""
    pos = 2
    while True:
        marker, (length,) = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])
        yield pos, marker, length
        if marker == 0xDA:
            return
        pos += 2 + length


def resized(data: bytes, marker: int, extra: bytes) -> bytes:
    """``data`` with ``extra`` appended to the body of its first ``marker``
    segment (the length field grown to match)."""
    for pos, m, length in markers(data):
        if m == marker:
            end = pos + 2 + length
            return (data[:pos + 2] + struct.pack(">H", length + len(extra))
                    + data[pos + 4:end] + extra + data[end:])
    raise ValueError(f"no marker {marker:#x}")


def dropped_dc_table(data: bytes) -> bytes:
    """``data`` with the DC table 0 of its DHT segments renumbered 2."""
    out = bytearray(data)
    for pos, m, length in markers(data):
        if m == 0xC4:
            at = pos + 4
            while at < pos + 2 + length:
                if out[at] == 0x00:
                    out[at] = 0x02
                at += 17 + sum(out[at + 1:at + 17])
    return bytes(out)


def reversed_scan_components(data: bytes) -> bytes:
    """``data`` with its first scan naming its components in reverse."""
    out = bytearray(data)
    at = out.index(b"\xff\xda") + 5
    ns = out[at - 1]
    out[at:at + 2 * ns] = b"".join(bytes(out[at + 2 * k:at + 2 * k + 2])
                                   for k in reversed(range(ns)))
    return bytes(out)


def damaged_cases() -> dict:
    """Files libjpeg refuses with a fatal error that the port once read
    (found by ``--fuzz`` and by the lossless files): the exact SOF and DRI
    lengths, the DAC segment's checks, a progressive scan whose Huffman
    table is missing (libjpeg's progressive decoder installs no standard
    tables), and a scan naming its components out of frame order."""
    base = encode(scene(24, 40, 9), quality=80, restart=1)
    prog = encode(scene(24, 40, 9), quality=80, progressive=1)
    sos = base.index(b"\xff\xda")
    dac = lambda body: base[:sos] + segment(0xCC, body) + base[sos:]  # noqa: E731
    return {
        "sof_longer": resized(base, 0xC0, b"\x00"),
        "dri_longer": resized(base, 0xDD, b"\x00"),
        "dac_index_32": dac(b"\x20\x00"),
        "dac_dc_low_above_high": dac(b"\x00\x1f"),
        "dac_odd_length": dac(b"\x10\x05\x00"),
        "progressive_without_dc_table_0": dropped_dc_table(prog),
        "scan_components_reversed": reversed_scan_components(
            encode(scene(24, 40, 9), quality=80, sampling="444")),
    }


@pytest.mark.parametrize("case", sorted(damaged_cases()))
def test_libjpeg_fatal_checks(tmp_path, case):
    data = damaged_cases()[case]
    assert cv2_read(tmp_path, data) is None
    with pytest.raises(ValueError):
        jpeg.decode(data)


def test_valid_dac_segments_and_sequential_missing_tables_still_read(tmp_path):
    """The counterparts that libjpeg reads: a DAC segment within bounds
    (conditioning values of no Huffman scan), and a sequential file
    without DHT segments (the standard tables)."""
    base = encode(scene(24, 40, 9), quality=80)
    sos = base.index(b"\xff\xda")
    data = base[:sos] + segment(0xCC, b"\x00\x10\x10\x05") + base[sos:]
    np.testing.assert_array_equal(jpeg.decode(data), cv2_read(tmp_path, data))
    data = dropped_dc_table(base)
    want = cv2_read(tmp_path, data)
    assert want is not None
    np.testing.assert_array_equal(jpeg.decode(data), want)


# ---- grey reads of colour files (label maps stored as JPEG) ----

def adobe_rgb(data: bytes, by_ids: bool = False) -> bytes:
    """An RGB-colourspace file from a YCbCr one: the JFIF APP0 replaced by
    an Adobe APP14 with transform 0, or (``by_ids``) the component ids
    renamed 'R', 'G', 'B' in the frame and every scan.  libjpeg then reads
    the three planes as R, G and B."""
    out = bytearray(data[:2])
    if not by_ids:
        out += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    for pos, m, length in markers(data):
        if m == 0xDA:
            rest = bytearray(data[pos:])
            break
        body = bytearray(data[pos:pos + 2 + length])
        if by_ids and m in (0xC0, 0xC2):
            body[10:19:3] = b"RGB"
        if m != 0xE0:
            out += body
    i = 0
    while by_ids and (i := rest.find(b"\xff\xda", i)) >= 0:
        for k in range(rest[i + 4]):
            rest[i + 5 + 2 * k] = b"RGB"[rest[i + 5 + 2 * k] - 1]
        i += 2
    return bytes(out + rest)


def ycck(data: bytes) -> bytes:
    """A PIL CMYK file with its Adobe transform set to 2 (YCCK)."""
    at = data.index(b"Adobe") + 11
    return data[:at] + b"\x02" + data[at + 1:]


def grey_cases() -> dict:
    out = {}
    for sampling in ("444", "420"):
        for progressive in (0, 1):
            data = encode(scene(45, 70, 3), quality=80, sampling=sampling,
                          progressive=progressive)
            out[f"rgb_adobe_{sampling}_p{progressive}"] = adobe_rgb(data)
            out[f"rgb_ids_{sampling}_p{progressive}"] = adobe_rgb(data, by_ids=True)
    for subsampling in (0, 2):
        out[f"cmyk_{subsampling}"] = cmyk_jpeg(scene(45, 70, 4), 85, subsampling)
        out[f"ycck_{subsampling}"] = ycck(out[f"cmyk_{subsampling}"])
    return out


@pytest.mark.parametrize("case", sorted(grey_cases()))
def test_grey_reads_of_rgb_cmyk_and_ycck_files_equal_cv2(tmp_path, case):
    """A label map stored as an RGB, CMYK or YCCK JPEG under a ``.png``
    name: ``image_io.imread_label`` equals ``cv2.imread(...,
    IMREAD_GRAYSCALE)`` (libjpeg's rgb_gray_convert; OpenCV's CMYK → grey
    on the CMYK libjpeg gives), and the colour read equals cv2's too."""
    data = grey_cases()[case]
    path = tmp_path / "mask.png"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert want is not None and want.shape == (45, 70)
    np.testing.assert_array_equal(image_io.imread_label(str(path)), want)
    np.testing.assert_array_equal(image_io.imread(str(path)), cv2.imread(str(path)))


# ---- lossless (SOF3) files ----

DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)  # Annex K.3's DC table, categories 0-11


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc, self.n = (self.acc << 1) | ((v >> i) & 1), self.n + 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes([self.acc])
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        while self.n:
            self.put(1, 1)
        return bytes(self.out)


def lossless_scan(x, precision, predictor, pt, restart_rows) -> bytes:
    """Entropy-coded data of one scan of the (H, W, C) samples ``x``
    (already shifted right by ``pt``): T.81 Annex H's predictions, the
    first row of the scan and of each restart interval from the left."""
    H, W, C = x.shape
    code, codes, k = 0, {}, 0
    for length, count in enumerate(DC_BITS, start=1):
        for _ in range(count):
            codes[k], code, k = (code, length), code + 1, k + 1
        code <<= 1
    bw, out, first = BitWriter(), b"", 0
    for y in range(H):
        if restart_rows and y and y % restart_rows == 0:
            out += bw.flush() + bytes([0xFF, 0xD0 + (y // restart_rows - 1) % 8])
            bw, first = BitWriter(), y
        for i in range(W):
            for c in range(C):
                if y == first:
                    p = x[y, i - 1, c] if i else 1 << (precision - pt - 1)
                elif i == 0:
                    p = x[y - 1, i, c]
                else:
                    ra, rb, rc = int(x[y, i - 1, c]), int(x[y - 1, i, c]), int(x[y - 1, i - 1, c])
                    p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                         6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                d = int(x[y, i, c]) - int(p)
                s = abs(d).bit_length()
                bw.put(*codes[s])
                if s:
                    bw.put(d if d > 0 else d + (1 << s) - 1, s)
    return out + bw.flush()


def lossless_jpeg(img, precision=8, predictor=1, pt=0, restart_rows=0, ids=None, app14=None,
                  scans=None, dht=True) -> bytes:
    """A lossless JPEG file of ``img`` ((H, W) or (H, W, C) samples below
    2^precision), each of ``scans`` (lists of component indices; default
    one interleaved scan) with the same predictor, point transform and
    restart interval (in rows), Huffman table 0 = Annex K.3's DC table."""
    img = np.asarray(img, np.int64).reshape(*np.shape(img)[:2], -1)
    H, W, C = img.shape
    ids = ids or list(range(1, C + 1))
    out = b"\xff\xd8"
    if app14 is not None:
        out += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, app14))
    out += segment(0xC3, struct.pack(">BHHB", precision, H, W, C)
                   + b"".join(bytes([i, 0x11, 0]) for i in ids))
    if dht:
        out += segment(0xC4, b"\x00" + bytes(DC_BITS) + bytes(range(12)))
    if restart_rows:
        out += segment(0xDD, struct.pack(">H", restart_rows * W))
    for comps in scans or [list(range(C))]:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], 0]) for c in comps)
                       + bytes([predictor, 0, pt]))
        out += lossless_scan(img[..., comps] >> pt, precision, predictor, pt, restart_rows)
    return out + b"\xff\xd9"


@pytest.mark.parametrize("precision", [2, 5, 8])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_grey_files_equal_cv2(tmp_path, precision, predictor):
    """A grey lossless file, read in grey as label maps are: the samples
    shifted back by the point transform, unscaled below 8 bits, equal to
    ``cv2.imread(..., IMREAD_GRAYSCALE)``; with and without restarts."""
    rng = np.random.RandomState(precision * 8 + predictor)
    img = rng.randint(0, 1 << precision, (11, 13))
    img[3:6, 4:9] = (1 << precision) - 1
    for pt in range(min(precision, 3)):
        for restart_rows in (0, 2):
            data = lossless_jpeg(img, precision, predictor, pt, restart_rows)
            want = cv2_read(tmp_path, data, flags=cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(want, (img >> pt) << pt)
            np.testing.assert_array_equal(jpeg.decode(data, grayscale=True), want)


def lossless_cases() -> dict:
    """Lossless files in each colour space; libjpeg converts none, so
    cv2 reads a grey file in grey only, an RGB one (no marker, ids 1-3 or
    'RGB', Adobe transform 0) in colour only, CMYK in both, and refuses
    YCbCr (JFIF, Adobe 1), YCCK, files without their Huffman table, a
    component no scan codes, 12 bits, and a scan naming components out of
    frame order."""
    rng = np.random.RandomState(7)
    rgb, cmyk = rng.randint(0, 256, (9, 11, 3)), rng.randint(0, 256, (9, 11, 4))
    jfif = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    return {"rgb": lossless_jpeg(rgb), "rgb_ids": lossless_jpeg(rgb, ids=[82, 71, 66]),
            "rgb_adobe0": lossless_jpeg(rgb, app14=0, predictor=6),
            "rgb_3_scans": lossless_jpeg(rgb, scans=[[0], [1], [2]], predictor=4, restart_rows=3),
            "rgb_2_scans": lossless_jpeg(rgb, scans=[[1, 2], [0]], predictor=7, pt=1),
            "cmyk": lossless_jpeg(cmyk), "cmyk_adobe0": lossless_jpeg(cmyk, app14=0),
            "grey": lossless_jpeg(rgb[..., 0]), "ycck": lossless_jpeg(cmyk, app14=2),
            "ycbcr_adobe1": lossless_jpeg(rgb, app14=1),
            "ycbcr_jfif": (lambda d: d[:2] + jfif + d[2:])(lossless_jpeg(rgb)),
            "no_dht": lossless_jpeg(rgb[..., 0], dht=False),
            "component_without_scan": lossless_jpeg(rgb, scans=[[0]]),
            "out_of_order_scan": lossless_jpeg(rgb, scans=[[2, 0], [1]]),
            "twelve_bit": lossless_jpeg(rgb[..., 0] * 16, precision=12, pt=4)}


@pytest.mark.parametrize("case", sorted(lossless_cases()))
def test_lossless_colour_spaces_as_cv2(tmp_path, case):
    data = lossless_cases()[case]
    for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
        want = cv2_read(tmp_path, data, flags=flag)
        if want is None:
            with pytest.raises(ValueError):
                jpeg.decode(data, grayscale=gray)
        else:
            np.testing.assert_array_equal(jpeg.decode(data, grayscale=gray), want)
    readable = {"rgb", "rgb_ids", "rgb_adobe0", "rgb_3_scans", "rgb_2_scans", "cmyk",
                "cmyk_adobe0", "grey"}
    assert (cv2_read(tmp_path, data) is not None
            or cv2_read(tmp_path, data, flags=cv2.IMREAD_GRAYSCALE) is not None) == (
        case in readable)


def test_damaged_lossless_files_read_as_cv2_or_not_at_all(tmp_path):
    """Lossless files damaged as ``fuzz`` damages them: what cv2 reads the
    port reads, pixel for pixel (a row begun after the data ran out is
    uniform grey, as libjpeg leaves it), and what cv2 refuses it refuses."""
    rng = np.random.RandomState(11)
    base = [lossless_jpeg(rng.randint(0, 256, (17, 23)), predictor=p, restart_rows=r)
            for p, r in ((1, 0), (4, 2), (7, 3))]
    counts = collections.Counter()
    for i in range(300):
        data = bytearray(base[i % 3])
        for _ in range(rng.randint(1, 6)):
            data[rng.randint(2, len(data))] = rng.randint(0, 256)
        if rng.rand() < 0.3:
            data = data[:rng.randint(2, len(data))]
        want = cv2_read(tmp_path, bytes(data), flags=cv2.IMREAD_GRAYSCALE)
        try:
            got = jpeg.decode(bytes(data), grayscale=True)
        except ValueError:
            got = None
        if want is None or got is None:
            counts["both refuse" if want is None and got is None else "one refuses"] += 1
        else:
            counts["equal" if np.array_equal(got, want) else "differ"] += 1
    assert counts["differ"] == 0 and counts["one refuses"] == 0, counts
    assert counts["equal"] > 150


# ---- arithmetic-coded files ----

ARITH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg_arith")
# name → (height, width, components, h_samp, v_samp, quality, mode, restart rows, DAC L, U, Kx):
# mode 0 sequential, 1 one sequential scan per component, 2 progressive
# (libjpeg's simple progression, with refinement scans); the DAC values
# are table 0's, the defaults (0, 1, 5) unless said
ARITH_FIXTURES = {
    "arith_grey_48x32.jpg": (32, 48, 1, 1, 1, 75, 0, 0, 0, 1, 5),
    "arith_grey_progressive_48x32.jpg": (32, 48, 1, 1, 1, 80, 2, 0, 0, 1, 5),
    "arith_444_restart_64x48.jpg": (48, 64, 3, 1, 1, 70, 0, 1, 0, 1, 5),
    "arith_444_q100_48x32.jpg": (32, 48, 3, 1, 1, 100, 0, 0, 0, 1, 5),
    "arith_420_64x48.jpg": (48, 64, 3, 2, 2, 90, 0, 0, 0, 1, 5),
    "arith_420_scans_restart_64x48.jpg": (48, 64, 3, 2, 2, 75, 1, 2, 0, 1, 5),
    "arith_422_progressive_restart_64x48.jpg": (48, 64, 3, 2, 1, 75, 2, 1, 0, 1, 5),
    "arith_420_progressive_64x48.jpg": (48, 64, 3, 2, 2, 85, 2, 0, 0, 1, 5),
    "arith_444_progressive_restart_56x40.jpg": (40, 56, 3, 1, 1, 80, 2, 1, 0, 1, 5),
    "arith_dac_420_64x48.jpg": (48, 64, 3, 2, 2, 85, 0, 0, 2, 6, 2),
    "arith_dac_progressive_64x48.jpg": (48, 64, 3, 2, 2, 95, 2, 0, 1, 3, 12),
}


def write_arith_fixtures() -> None:
    """Writes ``ARITH_FIXTURES`` with the system's libjpeg (``write_arith.c``
    in the fixtures' directory, built with ``cc ... -ljpeg``)."""
    import subprocess

    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "write_arith")
        subprocess.run(["cc", "-O2", "-o", exe, os.path.join(ARITH, "write_arith.c"), "-ljpeg"],
                       check=True)
        for i, (name, spec) in enumerate(sorted(ARITH_FIXTURES.items())):
            h, w, nc, hs, vs, q, mode, rst, dc_l, dc_u, ac_k = spec
            img = scene(h, w, 20 + i)
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if nc == 1 else img[..., ::-1]
            raw = os.path.join(tmp, "in.raw")
            with open(raw, "wb") as f:
                f.write(np.ascontiguousarray(img).tobytes())
            subprocess.run([exe, raw, str(w), str(h), str(nc), os.path.join(ARITH, name)]
                           + [str(v) for v in (hs, vs, q, mode, rst, dc_l, dc_u, ac_k)], check=True)


def arith_files() -> dict:
    """name → bytes of every arithmetic-coded file in ``ARITH``: the
    fixtures above and the two first ones (40×24, sequential and
    progressive, libjpeg's defaults)."""
    return {name: open(os.path.join(ARITH, name), "rb").read()
            for name in sorted(os.listdir(ARITH)) if name.endswith(".jpg")}


def without_dac(data: bytes) -> bytes:
    """``data`` with every DAC segment taken out: the conditioning falls
    back to libjpeg's defaults."""
    out, pos = bytearray(data[:2]), 2
    while True:
        marker, (length,) = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xDA:  # the rest, scans included, as it is (later DACs too)
            rest = data[pos:]
            while b"\xff\xcc" in rest:
                i = rest.index(b"\xff\xcc")
                (n,) = struct.unpack(">H", rest[i + 2:i + 4])
                rest = rest[:i] + rest[i + 2 + n:]
            return bytes(out + rest)
        if marker != 0xCC:
            out += data[pos:pos + 2 + length]
        pos += 2 + length


# the arithmetic-coded base files of the damaged-file fuzz
ARITH_FUZZ_BASE = ["arith_420_64x48.jpg", "arith_444_restart_64x48.jpg",
                   "arith_420_scans_restart_64x48.jpg", "arith_422_progressive_restart_64x48.jpg",
                   "arith_dac_progressive_64x48.jpg", "arith_grey_progressive_48x32.jpg"]


def test_arith_fixtures_are_the_listed_ones():
    names = set(arith_files())
    assert set(ARITH_FIXTURES) <= names and len(names) == len(ARITH_FIXTURES) + 2
    for name, data in arith_files().items():
        assert len(data) < 8192 and data[:2] == jpeg.SOI, name
        sof = [m for _, m, _ in markers(data) if m in (0xC9, 0xCA)]
        assert sof == [0xCA if "progressive" in name else 0xC9], name


@pytest.mark.parametrize("flags", [cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE], ids=["colour", "grey"])
@pytest.mark.parametrize("name", sorted(ARITH_FIXTURES) + ["arithmetic_progressive_40x24.jpg",
                                                           "arithmetic_sequential_40x24.jpg"])
def test_arithmetic_files_equal_cv2(name, flags):
    """Sequential (SOF9) and progressive (SOF10) files, grey, 4:4:4, 4:2:0
    and 4:2:2, with and without restarts, one scan per component, refinement
    scans, DAC conditioning other than the defaults: byte for byte."""
    path = os.path.join(ARITH, name)
    want = cv2.imread(path, flags)
    assert want is not None
    np.testing.assert_array_equal(image_io.imread(path, grayscale=flags == cv2.IMREAD_GRAYSCALE), want)


@pytest.mark.parametrize("name", ["arith_420_64x48.jpg", "arith_dac_420_64x48.jpg",
                                  "arith_dac_progressive_64x48.jpg"])
def test_arithmetic_files_without_dac_use_the_default_conditioning(tmp_path, name):
    """Without a DAC, L = 0, U = 1, Kx = 5: a file written with them reads
    as before; one written with others reads as libjpeg reads it with the
    defaults (other pixels, the same on both sides)."""
    data = without_dac(arith_files()[name])
    assert b"\xff\xcc" not in data
    want = cv2_read(tmp_path, data)
    assert want is not None
    np.testing.assert_array_equal(jpeg.decode(data), want)
    if name == "arith_420_64x48.jpg":
        np.testing.assert_array_equal(want, cv2.imread(os.path.join(ARITH, name)))


@pytest.mark.parametrize("name", ["arith_444_restart_64x48.jpg", "arith_420_scans_restart_64x48.jpg",
                                  "arith_422_progressive_restart_64x48.jpg",
                                  "arith_420_progressive_64x48.jpg", "arith_grey_progressive_48x32.jpg"])
def test_truncated_arithmetic_files(tmp_path, name):
    """Cut inside the first scan, half way and near the end: past the data
    the decoder reads zeros (a marker ends the input in arithmetic coding),
    and a progressive file left without its refinements is smoothed."""
    data = arith_files()[name]
    starts = scan_starts(data)
    cuts = [starts[0] + 30, (starts[0] + len(data)) // 2, len(data) - 20]
    if len(starts) > 1:
        cuts += [(starts[0] + starts[1]) // 2, starts[-1] + 20]
    for cut in cuts:
        want = cv2_read(tmp_path, data[:cut])
        if want is None:
            with pytest.raises(ValueError):
                jpeg.decode(data[:cut])
        else:
            np.testing.assert_array_equal(jpeg.decode(data[:cut]), want, err_msg=str(cut))
            np.testing.assert_array_equal(jpeg.decode(data[:cut], grayscale=True),
                                          cv2_read(tmp_path, data[:cut], flags=cv2.IMREAD_GRAYSCALE))


def test_arithmetic_corrupt_data_path(tmp_path):
    """libjpeg's "corrupt data" path: a spectral or magnitude overflow
    stops the restart interval (left as it is, ct = -1) and the next
    restart decodes again.  Flipped bytes inside the scans of each
    fixture, each read as cv2 reads it."""
    rng = np.random.RandomState(5)
    for name, data in arith_files().items():
        start = scan_starts(data)[0] + 12
        for _ in range(6):
            bad = bytearray(data)
            for _ in range(rng.randint(1, 4)):
                i = rng.randint(start, len(data) - 2)
                bad[i] = rng.randint(0, 255) if data[i - 1] != 0xFF else bad[i]
            want = cv2_read(tmp_path, bytes(bad))
            if want is None:
                with pytest.raises(ValueError):
                    jpeg.decode(bytes(bad))
            else:
                np.testing.assert_array_equal(jpeg.decode(bytes(bad)), want, err_msg=name)


# ---- the formats the port refuses ----


def twelve_bit_file() -> bytes:
    """One 8×8 block, SOF1 at 12-bit precision: DC 100, no AC."""
    dht = (segment(0xC4, b"\x00" + bytes([1] + [0] * 15) + b"\x07")
           + segment(0xC4, b"\x10" + bytes([1] + [0] * 15) + b"\x00"))
    return (b"\xff\xd8" + segment(0xDB, b"\x00" + b"\x01" * 64)
            + segment(0xC1, struct.pack(">BHHB", 12, 8, 8, 1) + b"\x01\x11\x00") + dht
            + segment(0xDA, b"\x01\x01\x00\x00\x3f\x00") + b"\x64\x7f\xff\xd9")


def with_sof(data: bytes, marker: int) -> bytes:
    """``data`` with its frame header's marker replaced."""
    pos = next(p for p, m, _ in markers(data) if m in _SOF_MARKERS)
    return data[:pos + 1] + bytes([marker]) + data[pos + 2:]


_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA}


def test_formats_the_port_refuses(tmp_path):
    """12-bit files, hierarchical frames (SOF5-7, 13-15) and lossless
    arithmetic-coded ones (SOF11): cv2 (libjpeg-turbo's 8-bit API, which
    decodes neither of the last two) refuses them, and so does the port,
    with a message naming the format.  Arithmetic-coded sequential and
    progressive files are read (the tests above)."""
    assert cv2_read(tmp_path, twelve_bit_file(), flags=cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match="precision other than 8 bits"):
        jpeg.decode(twelve_bit_file(), grayscale=True)
    base = encode(scene(24, 40, 9), quality=80)
    for marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        data = with_sof(base, marker)
        assert cv2_read(tmp_path, data) is None, hex(marker)
        with pytest.raises(ValueError, match="hierarchical"):
            jpeg.decode(data)
    img = cv2.cvtColor(scene(16, 24, 3), cv2.COLOR_BGR2GRAY)
    for data in (with_sof(lossless_jpeg(img), 0xCB), with_sof(arith_files()["arith_grey_48x32.jpg"], 0xCB)):
        assert cv2_read(tmp_path, data, flags=cv2.IMREAD_GRAYSCALE) is None
        with pytest.raises(ValueError, match="lossless arithmetic-coded"):
            jpeg.decode(data, grayscale=True)


def timings() -> dict:
    data = open(os.path.join(FIXTURES, "coco_640x427_420.jpg"), "rb").read()
    buf = np.frombuffer(data, np.uint8)
    out = {}
    for name, fn in (("port", lambda: jpeg.decode(data)),
                     ("cv2_imdecode", lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR))):
        fn()
        runs = []
        for _ in range(50):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        out[f"jpeg_640x427_ms_{name}"] = float(np.median(runs)) * 1e3
    rng = np.random.RandomState(0)
    h, stride = 1024, 2048 * 3
    for name, f in (("sub", 1), ("average", 3), ("paeth", 4)):
        raw = rng.randint(0, 256, (h, 1 + stride)).astype(np.uint8)
        raw[:, 0] = f
        for impl, fn in (("c", native.png_unfilter), ("numpy", png.unfilter_plain)):
            t0 = time.perf_counter()
            fn(raw.reshape(-1), h, stride, 3)
            out[f"png_unfilter_1024x2048_{name}_ms_{impl}"] = (time.perf_counter() - t0) * 1e3
    return out


# ---- image_io ----

def test_png_named_jpg_is_read_as_png(tmp_path):
    img = scene(19, 23, 7)
    path = tmp_path / "really_a_png.JPEG"
    cv2.imwrite(str(tmp_path / "a.png"), img)
    path.write_bytes((tmp_path / "a.png").read_bytes())
    np.testing.assert_array_equal(image_io.imread(str(path)), cv2.imread(str(path)))


def test_unreadable_files_raise(tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        image_io.imread(str(path))
    path.write_bytes(b"\xff\xd8\x00" + encode(scene(8, 8))[3:])  # not OpenCV's signature
    assert cv2.imread(str(path)) is None
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        image_io.imread(str(path))
    path.write_bytes(b"\xff\xd8\xff\xd9")
    with pytest.raises(ValueError, match="frame header"):
        image_io.imread(str(path))


def without_dht(data: bytes) -> bytes:
    """``data`` with its DHT segments cut out, as Motion-JPEG frames come."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


@pytest.mark.parametrize("sampling", ["420", "444"])
def test_missing_huffman_tables_are_the_standard_ones(tmp_path, sampling):
    """A scan whose table 0 or 1 no DHT defined reads the standard table
    of Annex K.3, as libjpeg does (the encoder's defaults are those)."""
    data = without_dht(encode(scene(21, 34, 8), quality=80, sampling=sampling))
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    want = cv2_read(tmp_path, data)
    assert want is not None
    np.testing.assert_array_equal(jpeg.decode(data), want)


def test_eight_threads_equal_one(tmp_path):
    files = [encode(scene(120 + 8 * i, 160, i), quality=70 + i, progressive=i % 2)
             for i in range(16)]
    one = [jpeg.decode(d) for d in files]
    with ThreadPoolExecutor(max_workers=8) as pool:
        many = list(pool.map(jpeg.decode, files * 4))
    for i, img in enumerate(many):
        np.testing.assert_array_equal(img, one[i % len(files)])


# ---- PNG ----

@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_png_unfilter_equals_numpy(bpp):
    rng = np.random.RandomState(bpp)
    h, w = 37, 29
    raw = rng.randint(0, 256, (h, 1 + w * bpp)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, h)
    raw[:5, 0] = [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(native.png_unfilter(raw.reshape(-1), h, w * bpp, bpp),
                                  png.unfilter_plain(raw.reshape(-1), h, w * bpp, bpp))
    raw[3, 0] = 5
    with pytest.raises(ValueError, match="filter 5"):
        native.png_unfilter(raw.reshape(-1), h, w * bpp, bpp)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
        print(json.dumps(manifest(), indent=1))
    if "--write-arith-fixtures" in sys.argv:
        write_arith_fixtures()
        print(json.dumps({k: len(v) for k, v in arith_files().items()}, indent=1))
    if "--fuzz" in sys.argv:
        n = int(sys.argv[sys.argv.index("--fuzz") + 1])
        print(json.dumps({seed: fuzz(n, seed) for seed in range(3)}))
    if "--time" in sys.argv:
        print(json.dumps(timings(), indent=1))
