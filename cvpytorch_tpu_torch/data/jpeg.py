"""JPEG reading as ``cv2.imread`` does it, on the port's host C decoder
(``native/jpeg.c``; the card's machine has neither OpenCV nor PIL).

``read_header`` walks the markers up to the first scan: the frame's size
(SOF) and the EXIF orientation of the first APP1 segment, read the way
OpenCV's ``ExifReader`` reads it (six bytes skipped, then a TIFF header
of either byte order, IFD0's tag 0x0112).  ``decode`` allocates the
output, runs the C decoder and applies the orientation as ``cv2.imread``
does by default (``ExifTransform``: flips and a transpose).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .. import native

SOI = b"\xff\xd8"
SIGNATURE = b"\xff\xd8\xff"  # what OpenCV's JPEG decoder takes for a JPEG file
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}
_ORIENTATION_TAG = 0x0112


@dataclass
class Header:
    height: int
    width: int
    orientation: int  # EXIF orientation, 1 (none) when absent or unreadable


def _exif_orientation(app1: bytes) -> int:
    """OpenCV's ExifReader on an APP1 payload: the value of IFD0's
    orientation entry, or 1."""
    tiff = app1[6:]
    if len(tiff) < 8:
        return 1
    order = "<" if tiff[:2] == b"II" else ">"  # "MM", or OpenCV's default when neither
    if struct.unpack(order + "H", tiff[2:4])[0] != 42:
        return 1
    (ifd,) = struct.unpack(order + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        entry = ifd + 2 + 12 * i
        if entry + 10 > len(tiff):
            break
        (tag,) = struct.unpack(order + "H", tiff[entry:entry + 2])
        if tag == _ORIENTATION_TAG:
            return struct.unpack(order + "H", tiff[entry + 8:entry + 10])[0]
    return 1


def read_header(data: bytes) -> Header:
    if data[:2] != SOI:
        raise ValueError("not a JPEG file")
    pos, sof, app1 = 2, None, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xFF, 0x00, 0x01) or 0xD0 <= marker <= 0xD8:
            pos += 1 if marker == 0xFF else 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xDA or marker == 0xD9:
            break
        if marker in _SOF and sof is None and len(body) >= 5:
            sof = struct.unpack(">HH", body[1:5])
        elif marker == 0xE1 and app1 is None:
            app1 = body
        pos += 2 + length
    if sof is None:
        raise ValueError("JPEG file without a frame header")
    height, width = sof
    return Header(height, width, _exif_orientation(app1) if app1 is not None else 1)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: orientation 1-8 → the upright image."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(data: bytes, grayscale: bool = False) -> np.ndarray:
    """JPEG bytes → what ``cv2.imread`` gives for the file: (H, W, 3) BGR
    uint8, or (H, W) with ``grayscale``."""
    header = read_header(data)
    img = native.jpeg_decode(data, header.height, header.width, gray=grayscale)
    return orient(img, header.orientation) if header.orientation != 1 else img
