"""Host C of the port: the COCO RLE codec and matcher (``rle.c``, a copy
of ``cvpytorch_tpu/native/rle.c``), the JPEG decoder (``jpeg.c``) and the
PNG row unfilter (``png_unfilter.c``).

The three sources are built at first use with the system C compiler
(``cc``, else ``gcc``; ``-O2 -fPIC -shared -std=c11``) into one library
under ``cvpytorch_tpu_torch/build/``, named by a hash of the sources and
the flags, and loaded with ``ctypes`` (whose calls release the GIL, so
loader threads decode in parallel).  A failed build raises: unlike
``cvpytorch_tpu/native``, nothing falls back to numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = tuple(_DIR / name for name in ("rle.c", "jpeg.c", "png_unfilter.c"))
BUILD_DIR = _DIR.parent / "build"
CFLAGS = ("-O2", "-fPIC", "-shared", "-std=c11")

_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F64 = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.c_int64

_lib = None
_lib_lock = threading.Lock()
build_seconds = None  # wall time of this process's build, None if it loaded a built one


def _compiler() -> str:
    for cc in ("cc", "gcc"):
        path = shutil.which(cc)
        if path:
            return path
    raise RuntimeError("no C compiler (cc or gcc) on PATH: the port's host library "
                       "(JPEG, PNG, COCO RLE) cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"host_{digest.hexdigest()[:16]}.so"


def _declare(lib) -> None:
    sigs = {
        "rle_decode_string": (_i64, [ctypes.c_char_p, _i64, _I64, _i64]),
        "rle_encode_string": (_i64, [_I64, _i64, ctypes.c_char_p, _i64]),
        "rle_from_mask": (_i64, [_U8, _i64, _I64, _i64]),
        "rle_to_mask": (None, [_I64, _i64, _U8, _i64]),
        "rle_area": (_i64, [_I64, _i64]),
        "rle_iou_matrix": (None, [_I64, _I64, _I64, _i64, _I64, _I64, _I64, _i64, _U8, _F64]),
        "coco_match": (None, [_F64, _i64, _i64, _F64, _i64, _U8, _U8, _I64, _U8, _U8, _U8]),
        "coco_match_areas": (None, [_F64, _i64, _i64, _F64, _i64, _U8, _U8, _F64, _F64, _F64,
                                    _F64, _i64, _U8, _U8, _I64, _U8, _I64]),
        "jpeg_decode": (_i64, [ctypes.c_char_p, _i64, _U8, _i64, _i64, _i64, ctypes.c_char_p,
                               _i64]),
        "png_unfilter": (_i64, [_U8, _i64, _i64, _i64, _U8]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the host library; cached per process."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            import time

            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([_compiler(), *CFLAGS, "-o", tmp, *map(str, SOURCES)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, so)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"building the host library failed:\n{e.stderr}") from e
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


# ---- COCO RLE codec and matcher (counterparts of cvpytorch_tpu/native) ----

def rle_decode_string(s) -> np.ndarray:
    """Compressed COCO RLE string → int64 run counts (first run = zeros)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    buf = np.empty(len(s) + 4, np.int64)  # at most one run per character
    m = load_library().rle_decode_string(s, len(s), _ptr(buf, _I64), buf.size)
    if m < 0:
        raise ValueError("malformed compressed RLE string")
    return buf[:m].copy()


def rle_encode_string(counts) -> str:
    """int64 run counts → compressed COCO RLE string."""
    counts = _as_i64(counts)
    buf = ctypes.create_string_buffer(int(counts.size) * 16 + 16)
    n = load_library().rle_encode_string(_ptr(counts, _I64), counts.size, buf, len(buf))
    if n < 0:
        raise ValueError("RLE string buffer too small")
    return buf.raw[:n].decode("ascii")


def rle_from_mask(mask: np.ndarray) -> np.ndarray:
    """uint8/bool (H, W) mask → run counts over the COLUMN-major raster."""
    flat = np.ascontiguousarray(np.asarray(mask).T.reshape(-1), np.uint8)
    buf = np.empty(flat.size + 2, np.int64)
    m = load_library().rle_from_mask(_ptr(flat, _U8), flat.size, _ptr(buf, _I64), buf.size)
    return buf[:m].copy()


def rle_to_mask(counts, height: int, width: int) -> np.ndarray:
    """Run counts → uint8 (H, W) mask (column-major raster order)."""
    counts = _as_i64(counts)
    flat = np.empty(height * width, np.uint8)
    load_library().rle_to_mask(_ptr(counts, _I64), counts.size, _ptr(flat, _U8), flat.size)
    return flat.reshape(width, height).T


def rle_area(counts) -> int:
    counts = _as_i64(counts)
    return int(load_library().rle_area(_ptr(counts, _I64), counts.size))


def rle_iou(dt_counts: list, gt_counts: list, iscrowd) -> np.ndarray:
    """Pairwise IoU (D, G) between two lists of run-count arrays on the
    same canvas; a crowd GT gives intersection / det area."""
    D, G = len(dt_counts), len(gt_counts)
    out = np.zeros((D, G))
    if D == 0 or G == 0:
        return out
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    dc, gc = _as_i64(np.concatenate(dt_counts)), _as_i64(np.concatenate(gt_counts))
    dlen = _as_i64([len(c) for c in dt_counts])
    glen = _as_i64([len(c) for c in gt_counts])
    doff = _as_i64(np.concatenate([[0], np.cumsum(dlen)[:-1]]))
    goff = _as_i64(np.concatenate([[0], np.cumsum(glen)[:-1]]))
    load_library().rle_iou_matrix(
        _ptr(dc, _I64), _ptr(doff, _I64), _ptr(dlen, _I64), D,
        _ptr(gc, _I64), _ptr(goff, _I64), _ptr(glen, _I64), G,
        _ptr(crowd, _U8), _ptr(out, _F64))
    return out


def coco_match(ious, thrs, gt_ig, gt_crowd, gt_order):
    """Greedy COCO matching of one (image, category, area range) cell:
    ious (D, G) with detections in score order, thrs (T,), gt_ig and
    gt_crowd (G,) bool, gt_order (G,) non-ignored first →
    (dtm, dtig), each (T, D) bool."""
    ious = np.ascontiguousarray(ious, np.float64)
    D, G = ious.shape
    thrs = np.ascontiguousarray(thrs, np.float64)
    T = thrs.size
    gt_ig8 = np.ascontiguousarray(gt_ig, np.uint8)
    crowd8 = np.ascontiguousarray(gt_crowd, np.uint8)
    order = _as_i64(gt_order)
    dtm = np.zeros((T, D), np.uint8)
    dtig = np.zeros((T, D), np.uint8)
    scratch = np.empty(max(G, 1), np.uint8)
    load_library().coco_match(
        _ptr(ious, _F64), D, G, _ptr(thrs, _F64), T, _ptr(gt_ig8, _U8), _ptr(crowd8, _U8),
        _ptr(order, _I64), _ptr(dtm, _U8), _ptr(dtig, _U8), _ptr(scratch, _U8))
    return dtm.astype(bool), dtig.astype(bool)


def coco_match_areas(ious, thrs, gt_base_ig, gt_crowd, gt_areas, dt_areas, area_ranges):
    """Every area range's matching in one call: per range the GT ignore
    set (base, or area out of range), the stable non-ignored-first order,
    all thresholds, and the out-of-range unmatched detections ignored →
    (dtm (A, T, D) bool, dtig (A, T, D) bool, npig (A,) int64)."""
    ious = np.ascontiguousarray(ious, np.float64)
    D, G = ious.shape
    thrs = np.ascontiguousarray(thrs, np.float64)
    T = thrs.size
    lo = np.ascontiguousarray([r[0] for r in area_ranges], np.float64)
    hi = np.ascontiguousarray([r[1] for r in area_ranges], np.float64)
    A = lo.size
    base8 = np.ascontiguousarray(gt_base_ig, np.uint8)
    crowd8 = np.ascontiguousarray(gt_crowd, np.uint8)
    ga = np.ascontiguousarray(gt_areas, np.float64)
    da = np.ascontiguousarray(dt_areas, np.float64)
    dtm = np.zeros((A, T, D), np.uint8)
    dtig = np.zeros((A, T, D), np.uint8)
    npig = np.zeros(A, np.int64)
    scratch = np.empty(max(2 * G, 1), np.uint8)
    order = np.empty(max(G, 1), np.int64)
    load_library().coco_match_areas(
        _ptr(ious, _F64), D, G, _ptr(thrs, _F64), T, _ptr(base8, _U8), _ptr(crowd8, _U8),
        _ptr(ga, _F64), _ptr(da, _F64), _ptr(lo, _F64), _ptr(hi, _F64), A,
        _ptr(dtm, _U8), _ptr(dtig, _U8), _ptr(npig, _I64), _ptr(scratch, _U8),
        _ptr(order, _I64))
    return dtm.astype(bool), dtig.astype(bool), npig


# ---- image codecs ----

def jpeg_decode(data: bytes, height: int, width: int, gray: bool = False) -> np.ndarray:
    """JPEG bytes → (H, W, 3) BGR uint8, or (H, W) with ``gray``, as
    libjpeg-turbo decodes them for ``cv2.imread`` (no EXIF rotation:
    ``data/jpeg.py`` applies it).  Raises ``ValueError`` on what it cannot
    decode."""
    out = np.empty((height, width) if gray else (height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = load_library().jpeg_decode(data, len(data), _ptr(out, _U8), height, width,
                                    int(gray), err, len(err))
    if rc != 0:
        raise ValueError(err.value.decode() or "JPEG decoding failed")
    return out


def png_unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """The five PNG row filters undone: ``raw`` holds ``height`` rows of a
    filter byte and ``stride`` filtered bytes → (height, stride) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = load_library().png_unfilter(_ptr(raw, _U8), height, stride, bpp, _ptr(out, _U8))
    if bad < 0:
        raise MemoryError("PNG unfilter")
    if bad:
        raise ValueError(f"PNG row filter {raw[(bad - 1) * (stride + 1)]} does not exist")
    return out
