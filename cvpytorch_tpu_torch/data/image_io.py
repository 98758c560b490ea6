"""``imread(path, grayscale=False)`` with ``cv2.imread``'s contract for
the files the datasets hold: (H, W, 3) BGR uint8, or (H, W) with
``grayscale``.  The format is told by the file's signature, not its
name (ImageNet has PNG data in ``.JPEG`` files); a file that is neither
JPEG nor PNG, or that the decoder cannot read, raises.

``imread_label(path)`` reads a segmentation or instance map: a palette
PNG as its indices (where ``cv2.IMREAD_GRAYSCALE``, and so the JAX
datasets, read the luma of the palette's colours), any other file as
``imread(path, grayscale=True)``."""
from __future__ import annotations

import numpy as np

from . import jpeg, png


def decode(data: bytes, grayscale: bool = False, name: str = "image") -> np.ndarray:
    if data[:3] == jpeg.SIGNATURE:
        return jpeg.decode(data, grayscale=grayscale)
    if data[:8] == png.SIGNATURE:
        return png.decode_image(data, grayscale=grayscale, name=name)
    raise ValueError(f"{name}: neither a JPEG nor a PNG file")


def imread(path: str, grayscale: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data, grayscale, name=path)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def imread_label(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:8] == png.SIGNATURE:
            return png.decode_label(data, name=path)
        return decode(data, grayscale=True, name=path)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
