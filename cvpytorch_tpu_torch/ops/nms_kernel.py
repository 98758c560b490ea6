"""Greedy NMS keep mask: the CUDA kernel's wrapper and its plain version.

Counterpart of the TPU kernel ``pallas_nms_keep``
(``cvpytorch_tpu/ops/pallas/nms_kernel.py``).  ``nms_keep`` takes a batch
of score-sorted, class-offset boxes and returns which survive greedy
suppression.  A CPU tensor goes to ``nms_keep_plain``; a CUDA tensor goes
to the kernel in ``csrc/nms_kernel.cu``, which is built with ``nvcc`` for
``sm_90a`` into ``build/`` at first use (keyed by a hash of the source and
flags) and loaded with ``ctypes``.  A failed build or launch raises.
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
import torch

from .boxes import box_iou_matrix

MAX_K = 1024  # every caller has K <= max_nms = 1024

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nms_kernel.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the NMS kernel cannot be built")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"nms_kernel_{digest.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
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
                subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, so)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(str(so))
        lib.cvt_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p, ctypes.c_void_p]
        lib.cvt_nms_keep.restype = ctypes.c_int
        lib.cvt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cvt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _f32(x: float) -> float:
    """The f32 value of a threshold, so every path compares in f32."""
    return float(np.float32(x))


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


def nms_keep(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask: boxes (B, K, 4) f32 xyxy, score-sorted
    descending with class offsets applied → (B, K) bool.

    CPU tensors take ``nms_keep_plain``; CUDA tensors launch the kernel
    (counted in ``nms_keep.launches``).  Raises for K > 1024, and for a
    CUDA input that is not f32 and contiguous."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    B, K, _ = boxes.shape
    if K > MAX_K:
        raise ValueError(f"nms_keep takes K <= {MAX_K}, got {K}")
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep runs on cpu or cuda, got {boxes.device}")
    if boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError("nms_keep needs a contiguous float32 tensor")
    keep = torch.empty((B, K), dtype=torch.uint8, device=boxes.device)
    if B == 0 or K == 0:
        return keep.bool()
    lib = load_library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = lib.cvt_nms_keep(boxes.data_ptr(), B, K, _f32(iou_threshold),
                              keep.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("nms_keep launch failed: "
                           f"{lib.cvt_cuda_error_string(rc).decode()}")
    nms_keep.launches += 1
    return keep.view(torch.bool)


nms_keep.launches = 0
