"""The port's image readers against ``cv2.imread`` (OpenCV 5.0.0, its
bundled libjpeg-turbo 3.1.2), byte for byte, no tolerance:

* the JPEG decoder (``native/jpeg.c`` + ``data/jpeg.py``) on files written
  here by OpenCV (the five sampling factors it writes, qualities 5-100,
  sizes 1×1 to 427×640, baseline and progressive, optimised Huffman
  tables, restart intervals), grey files, CMYK files written by PIL, EXIF
  orientations 1-8 in either byte order, and files cut short (baseline,
  and progressive in its first scan and later: libjpeg's block smoothing);
* the committed fixtures (``tests/data/torch_jpeg``) against the sha256 of
  ``cv2.imread``'s pixels in their manifest, which also holds the decoder
  to libjpeg-turbo where OpenCV is absent (``chip_smoke.py``);
* ``image_io.imread``'s dispatch on the file's signature (a PNG named
  ``.jpg``), its refusal of other files, and 8 threads against one;
* the PNG row unfilter in C against its numpy plain version.

``python -m tests.test_torch_jpeg --write-fixtures`` writes the fixtures
and their manifest anew (OpenCV and PIL write them); ``--fuzz N`` prints
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
    each read by ``image_io.decode`` and by ``cv2.imread`` → counts of
    equal, both refused, port reads / cv2 refuses, cv2 reads / port
    refuses, and differ."""
    rng = np.random.RandomState(seed)
    kinds = [("420", 0), ("444", 1), ("422", 1), ("411", 0), ("440", 1)]
    base = [encode(scene(37 + 5 * i, 53 + 7 * i, i), quality=60 + 7 * i, sampling=k,
                   progressive=p, restart=i % 2) for i, (k, p) in enumerate(kinds)]
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
    """No crash, no other pixels than cv2's, and nothing cv2 reads is
    refused; the port may read a damaged file cv2 refuses (ROADMAP)."""
    counts = fuzz(150, 0)
    assert counts["differ"] == 0 and counts["cv2 reads, port refuses"] == 0, counts
    assert counts["equal"] > 50


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
    if "--fuzz" in sys.argv:
        n = int(sys.argv[sys.argv.index("--fuzz") + 1])
        print(json.dumps({seed: fuzz(n, seed) for seed in range(3)}))
    if "--time" in sys.argv:
        print(json.dumps(timings(), indent=1))
