"""PNG codec on the standard library's ``zlib`` (the card's machine has
neither OpenCV nor PIL).

* ``write_palette_png(path, index, palette)`` — an 8-bit palette image
  (colour type 3), every row unfiltered, the palette as given;
* ``write_png(path, img)`` — an (H, W) gray or (H, W, 3) BGR uint8 image
  as ``cv2.imwrite`` takes it, as an 8-bit gray or RGB file, every row
  unfiltered;
* ``imread(path, grayscale=False)`` — what ``cv2.imread`` returns for an
  8-bit, non-interlaced gray, gray+alpha, RGB, RGBA or palette PNG: (H, W,
  3) uint8 BGR, alpha dropped, gray replicated; with ``grayscale`` the
  (H, W) map: a gray file as it is, a colour or palette file (its
  colours) through libpng's ``png_set_rgb_to_gray(0.299, 0.587)``, which
  OpenCV asks for: (9797 R + 19234 G + 3737 B) >> 15, equal to
  ``cv2.imread(..., IMREAD_GRAYSCALE)`` on all 2^24 colours;
* ``decode_label`` — a label map: palette files as their indices (VOC's
  ``SegmentationClass``, PennFudan's ``PedMasks``), any other file as
  ``decode_image(grayscale=True)`` reads it.

The reader undoes the five row filters in host C (``native/png_unfilter.c``).
``_unfilter_rows`` and ``_unfilter_diagonals`` are their plain numpy
version, which the tests hold the C to and nothing else calls: None, Sub
(a cumulative sum mod 256 along the row) and Up row by row; Average and
Paeth by anti-diagonals, since pixel (y, x) needs only (y, x−1), (y−1, x)
and (y−1, x−1) (H + W − 1 vectorised steps).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write(path: str, rows: np.ndarray, w: int, ctype: int, extra: bytes = b"") -> None:
    """``rows`` (H, 1 + stride) uint8, each row its filter byte then its samples."""
    h = rows.shape[0]
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(extra)
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        samples, ctype = img, 0
    elif img.ndim == 3 and img.shape[2] == 3:
        samples, ctype = img[..., ::-1].reshape(img.shape[0], -1), 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), not {img.shape}")
    rows = np.concatenate([np.zeros((img.shape[0], 1), np.uint8), samples], axis=1)
    _write(path, rows, img.shape[1], ctype)


def write_palette_png(path: str, index: np.ndarray, palette) -> None:
    """``index`` (H, W) uint8 palette indices; ``palette`` a flat R, G, B
    sequence of at most 256 colours."""
    index = np.ascontiguousarray(index, dtype=np.uint8)
    if index.ndim != 2:
        raise ValueError(f"palette PNG takes an (H, W) map, not {index.shape}")
    pal = bytes(int(v) for v in palette)
    if not pal or len(pal) % 3 or len(pal) > 768:
        raise ValueError(f"palette of {len(pal)} values is not 1-256 RGB colours")
    h, w = index.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), index], axis=1)  # filter 0
    _write(path, rows, w, 3, _chunk(b"PLTE", pal))


def _read_chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before IEND")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(types: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up rows, one vectorised step per row."""
    out = np.empty_like(data)
    prev = np.zeros(data.shape[1], np.uint8)
    for y, t in enumerate(types):
        row = data[y]
        if t == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif t == 2:
            row = row + prev
        out[y] = prev = row
    return out


def _unfilter_diagonals(types: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, one vectorised step per anti-diagonal."""
    h, stride = data.shape
    w = stride // bpp
    filt = data.reshape(h, w, bpp).astype(np.int16)
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row and column in front
    t = types.astype(np.int64)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        ty = t[ys][:, None]
        pred = np.where(ty == 1, a, np.where(ty == 2, b, np.where(
            ty == 3, (a + b) >> 1, np.where(ty == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode(data: bytes) -> tuple[np.ndarray, int, bytes | None]:
    """PNG bytes → ((H, W, samples) uint8, colour type, PLTE or None)."""
    header, palette, idat = None, None, []
    for kind, body in _read_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _SAMPLES or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (8-bit, non-interlaced only)")
    bpp = _SAMPLES[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return native.png_unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp), ctype, palette


def unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The numpy version of ``native.png_unfilter``."""
    raw = raw.reshape(h, 1 + stride)
    types, filtered = raw[:, 0], raw[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {types.max()} does not exist")
    unfilter = _unfilter_diagonals if (types >= 3).any() else _unfilter_rows
    return unfilter(types, filtered, bpp)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(..., 3+) uint8 RGB → uint8 gray by libpng's 8-bit rgb_to_gray
    (weights 0.299, 0.587 in 1/32768, truncated; no gamma)."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _palette_colours(pixels: np.ndarray, palette: bytes | None, name: str) -> np.ndarray:
    if palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    lut = np.zeros((256, 3), np.uint8)
    colours = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    lut[:len(colours)] = colours
    return lut[pixels[..., 0]]


def decode_image(data: bytes, grayscale: bool = False, name: str = "PNG") -> np.ndarray:
    """PNG bytes → what ``cv2.imread`` gives for the file."""
    pixels, ctype, palette = decode(data)
    if ctype == 3:
        pixels = _palette_colours(pixels, palette, name)
    if ctype in (0, 4):
        if grayscale:
            return np.ascontiguousarray(pixels[..., 0])
        return np.repeat(pixels[..., :1], 3, axis=2)
    if grayscale:
        return rgb_to_gray(pixels)
    return np.ascontiguousarray(pixels[..., 2::-1])


def decode_label(data: bytes, name: str = "PNG") -> np.ndarray:
    """PNG bytes → (H, W) uint8 class or instance map: a palette file's
    indices, any other file as ``decode_image(grayscale=True)``."""
    pixels, ctype, _ = decode(data)
    if ctype == 3:
        return np.ascontiguousarray(pixels[..., 0])
    return decode_image(data, grayscale=True, name=name)


def imread(path: str, grayscale: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read(), grayscale, name=path)
