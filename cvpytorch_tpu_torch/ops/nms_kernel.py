"""Greedy NMS keep mask: the CUDA kernel's wrapper and its plain version.

Counterpart of the TPU kernel ``pallas_nms_keep``
(``cvpytorch_tpu/ops/pallas/nms_kernel.py``).  ``nms_keep`` takes a batch
of score-sorted, class-offset boxes and returns which survive greedy
suppression.  A CPU tensor goes to ``nms_keep_plain``; a CUDA tensor goes
to the kernels in ``csrc/nms_kernel.cu`` (a tiled IoU-bitmask kernel, then
a blocked scan: two device launches per call).  Traced and exported code
reaches both through the ``torch.library`` op ``cvt::nms_keep``, so that
``torch.export`` keeps the call as one node of the exported program.  The
kernels are built with
``nvcc`` for ``sm_90a`` into ``build/`` at first use (keyed by a hash of
every source in ``csrc/`` and the flags) and loaded with ``ctypes``.  A
failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from .boxes import box_iou_matrix

MAX_K = 1024  # every caller has K <= max_nms = 1024
DEVICE_KERNELS_PER_CALL = 2  # the mask kernel, then the scan kernel
TILE = 64  # boxes per tile and bits per mask word, as in the kernel
BAND = 2.0 ** -16  # relative half-width of the band where the division decides

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "nms_kernel.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the NMS kernel cannot be built")
    return path


def library_path() -> Path:
    """The built library, named by a hash of every source under ``csrc/``
    (a changed header rebuilds too) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"nms_kernel_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """What ``-Xptxas -v`` said when the loaded library was built:
    registers, shared memory and spills of each kernel."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def _write_atomic(path: Path, text: str) -> None:
    """``path`` appears whole or not at all (a temporary file, renamed)."""
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process.
    Processes that build at once (data-parallel ranks) each build into a
    temporary file and rename it over the library, the build log first, so
    a process never loads or reads a file that is half written."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                                      check=True, capture_output=True, text=True)
                _write_atomic(so.with_suffix(".ptxas.txt"), done.stdout + done.stderr)
                os.replace(tmp, so)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(str(so))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvt_nms_keep.argtypes = [ptr, i32, i32, f32, f32, f32, ptr, ptr, ptr]
        lib.cvt_nms_keep.restype = i32
        lib.cvt_cuda_error_string.argtypes = [i32]
        lib.cvt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _f32(x: float) -> float:
    """The f32 value of a threshold, so every path compares in f32."""
    return float(np.float32(x))


def mask_words(B: int, K: int) -> int:
    """u64 words of the mask kernel's scratch: for each image, 64 words
    for each tile pair r <= c of the T = ceil(K / 64) tiles."""
    T = -(-K // TILE)
    return B * T * (T + 1) // 2 * TILE


@functools.lru_cache(maxsize=64)
def division_band(thr: float) -> tuple[float, float]:
    """(lo, hi), f32, for the mask kernel's test of IoU = inter / d > thr
    without a division: q = inter * rcp(d), with rcp within 1 ulp of 1/d,
    is within 2^-22 of inter / d, so q > hi means RN(inter / d) > thr and
    q < lo means it is not; q in [lo, hi] takes the IEEE division.
    lo <= thr (1 - 2^-16) and hi >= thr (1 + 2^-16), rounded outward (the
    products are exact in f64).  A threshold outside [2^-100, 2^100]
    (zero, negative, subnormal, NaN) gives (-inf, inf): every pair divides."""
    t = _f32(thr)
    if not 2.0 ** -100 <= t <= 2.0 ** 100:
        return -np.inf, np.inf
    lo, hi = t * (1 - BAND), t * (1 + BAND)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    if lo32 > lo:
        lo32 = np.nextafter(lo32, np.float32(-np.inf))
    if hi32 < hi:
        hi32 = np.nextafter(hi32, np.float32(np.inf))
    return float(lo32), float(hi32)


def nms_keep_plain(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch greedy NMS: boxes (B, K, 4) xyxy, score-sorted
    descending → keep (B, K) bool.  Suppress j > i iff keep[i] and
    IoU(i, j) > thr (strict), the arithmetic of ``box_iou_matrix``."""
    B, K, _ = boxes.shape
    over = box_iou_matrix(boxes, boxes) > _f32(iou_threshold)
    over &= torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    keep = torch.ones(B, K, dtype=torch.bool, device=boxes.device)
    for i in range(K):
        keep &= ~(over[:, i] & keep[:, i:i + 1])
    return keep


def _check(boxes: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if boxes.shape[1] > MAX_K:
        raise ValueError(f"nms_keep takes K <= {MAX_K}, got {boxes.shape[1]}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_keep runs on cpu or cuda, got {boxes.device}")


def _launch(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The CUDA kernels on a CUDA tensor: two device launches, counted as
    one call in ``nms_keep.launches``."""
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError("nms_keep needs a contiguous float32 tensor")
    B, K, _ = boxes.shape
    keep = torch.empty((B, K), dtype=torch.uint8, device=boxes.device)
    if B == 0 or K == 0:
        return keep.bool()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    lib = load_library()
    mask = torch.empty(mask_words(B, K), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = lib.cvt_nms_keep(boxes.data_ptr(), B, K, _f32(iou_threshold),
                              *division_band(iou_threshold), mask.data_ptr(),
                              keep.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("nms_keep launch failed: "
                           f"{lib.cvt_cuda_error_string(rc).decode()}")
    nms_keep.launches += 1
    return keep.view(torch.bool)


def _nms_keep(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    _check(boxes)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, iou_threshold)
    return _launch(boxes, iou_threshold)


@torch.library.custom_op("cvt::nms_keep", mutates_args=())
def nms_keep_op(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``cvt::nms_keep``: one node in a traced or exported graph, which
    ``torch.export`` saves by name; the program that loads it imports this
    module to find it again.  CPU tensors take ``nms_keep_plain``, CUDA
    tensors the kernels."""
    return _nms_keep(boxes, iou_threshold)


@nms_keep_op.register_fake
def _(boxes, iou_threshold):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def nms_keep(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask: boxes (B, K, 4) f32 xyxy, score-sorted
    descending with class offsets applied → (B, K) bool.

    CPU tensors take ``nms_keep_plain``; CUDA tensors launch the kernels,
    two device kernels counted as one call in ``nms_keep.launches``.
    Raises for K > 1024, for a device other than the CPU or CUDA, and for
    a CUDA input that is not f32 and contiguous.  Traced or exported code
    (``torch.compile``, ``torch.export``) calls the ``cvt::nms_keep`` op;
    eager code calls its implementation directly, which saves the
    dispatcher's Python path (~12 µs a call on an H100's host: 0.046
    against 0.058 ms a call at (32, 1024), ``chip_smoke.py``)."""
    if torch.compiler.is_compiling() or isinstance(boxes, FakeTensor):
        _check(boxes)
        return torch.ops.cvt.nms_keep(boxes, iou_threshold)
    return _nms_keep(boxes, iou_threshold)


nms_keep.launches = 0
