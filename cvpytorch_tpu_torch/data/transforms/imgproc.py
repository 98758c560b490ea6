"""OpenCV's uint8 image operations that the segmentation transforms use,
in numpy, to the bit where OpenCV's own arithmetic is integer
(``cv2`` is not on the card's machine).

* ``resize_linear`` — ``cv2.resize(..., INTER_LINEAR)`` on uint8: the
  half-pixel source coordinate in float32, horizontal weights rounded to
  11 bits (the source column clamped at both edges, its weight with it),
  the vertical pass in OpenCV's vectorised fixed point
  ``((S0 >> 4)·b0 >> 16) + ((S1 >> 4)·b1 >> 16)``, then ``(v + 2) >> 2``;
  an exact 2× downscale on both axes is OpenCV's 2×2 area mean
  ``(a + b + c + d + 2) >> 2``, and an equal size is a copy.
* ``resize_nearest`` — ``cv2.INTER_NEAREST``: source index
  ``floor(i · src/dst)`` in double, clamped (not half-pixel).
* ``bgr_to_hsv`` / ``hsv_to_bgr`` — ``COLOR_BGR2HSV`` on uint8 (integer
  arithmetic on OpenCV's division tables, H in [0, 180)) and
  ``COLOR_HSV2BGR`` (through float32 with fused multiply-adds; OpenCV's
  vector steps truncate to uint8, the scalar tail of each row rounds).

Each resize takes optional ``rows``/``cols``: the output window to
compute (non-empty slices of step 1), so that a random crop of a large resize computes only the crop
(each output pixel depends on its own coordinates only; the result is the
crop of the full resize).
"""
from __future__ import annotations

import numpy as np

_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """Source index and 11-bit weights of each output position, as
    OpenCV's ``resize`` computes them; ``clamp`` is the horizontal rule
    (an out-of-range source takes the edge pixel with weight 1)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low, high = s < 0, s >= n_in - 1
        f[low | high] = 0
        s[low] = 0
        s[high] = n_in - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return s, w0, w1


def _window(n: int, sel: slice | None) -> np.ndarray:
    return np.arange(n)[sel if sel is not None else slice(None)]


def _is_exact_half(n_in: int, n_out: int) -> bool:
    scale = 1.0 / (n_out / n_in)
    return abs(scale - 2) < np.finfo(np.float64).eps


def resize_linear(img: np.ndarray, size: tuple[int, int], rows: slice | None = None,
                  cols: slice | None = None) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → (h, w[, C]) for ``size`` = (h, w), or
    its ``rows`` × ``cols`` window."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, not {img.dtype}")
    H, W = img.shape[:2]
    oh, ow = size
    ys, xs = _window(oh, rows), _window(ow, cols)
    if (oh, ow) == (H, W):
        return np.ascontiguousarray(img[ys[:, None], xs[None, :]])
    if _is_exact_half(H, oh) and _is_exact_half(W, ow):
        # OpenCV's 2×2 area mean on the window's source block: row pairs,
        # then column pairs
        block = img[2 * ys[0]:2 * ys[-1] + 2, 2 * xs[0]:2 * xs[-1] + 2]
        pairs = block.reshape(len(ys), 2, -1)
        r = (pairs[:, 0].astype(np.uint16) + pairs[:, 1]).reshape(len(ys), len(xs), 2, -1)
        out = r[:, :, 0] + r[:, :, 1]
        out += 2
        out >>= 2
        return out.astype(np.uint8).reshape((len(ys), len(xs)) + img.shape[2:])
    sx, a0, a1 = (t[xs] for t in _linear_taps(W, ow, clamp=True))
    sy, b0, b1 = (t[ys] for t in _linear_taps(H, oh, clamp=False))
    sx1 = np.minimum(sx + 1, W - 1)
    r0, r1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)
    need = np.unique(np.concatenate([r0, r1]))
    # the horizontal pass on the rows it needs, as (row, x·C + channel)
    # columns gathered with np.take (faster than indexing the middle axis)
    src = img[need].reshape(len(need), -1)
    C = src.shape[1] // W
    chan = np.arange(C)
    horiz = np.take(src, (sx[:, None] * C + chan).ravel(), axis=1).astype(np.int32)
    horiz *= np.repeat(a0, C)
    right = np.take(src, (sx1[:, None] * C + chan).ravel(), axis=1).astype(np.int32)
    right *= np.repeat(a1, C)
    horiz += right
    # the vertical pass: ((S0 >> 4)·b0 >> 16) + ((S1 >> 4)·b1 >> 16), in place
    pos = np.searchsorted(need, np.stack([r0, r1]))
    top, bottom = horiz[pos[0]], horiz[pos[1]]
    for v, b in ((top, b0), (bottom, b1)):
        v >>= 4
        v *= b[:, None]
        v >>= 16
    top += bottom
    top += 2
    top >>= 2
    np.clip(top, 0, 255, out=top)
    return top.astype(np.uint8).reshape((len(ys), len(xs)) + img.shape[2:])


def resize_nearest(img: np.ndarray, size: tuple[int, int], rows: slice | None = None,
                   cols: slice | None = None) -> np.ndarray:
    """Any dtype (H, W[, C]) → (h, w[, C]) by OpenCV's nearest rule."""
    H, W = img.shape[:2]
    oh, ow = size
    ys, xs = _window(oh, rows), _window(ow, cols)
    sy = np.minimum(np.floor(ys * (1.0 / (oh / H))).astype(np.int64), H - 1)
    sx = np.minimum(np.floor(xs * (1.0 / (ow / W))).astype(np.int64), W - 1)
    return np.ascontiguousarray(img[sy[:, None], sx[None, :]])


_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV180 = _hsv_tables()


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 BGR (..., 3) → uint8 HSV with H in [0, 180)."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


# (b, g, r) ← columns of (v, v(1 − s), v(1 − s·f), v(1 − s(1 − f))) per sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_HSV_BLOCK = 32  # pixels per vector step of OpenCV's HSV2BGR (x86-64 builds)


def _hsv_to_bgr_f32(hsv: np.ndarray) -> np.ndarray:
    f32 = np.float32
    h = hsv[..., 0].astype(f32)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h * f32(6.0 / 180.0), f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    out_of_range = (sector < 0) | (sector >= 6)
    sector = np.where(out_of_range, 0, sector)
    h = np.where(out_of_range, f32(0), h)
    one = f32(1)

    def one_minus_s_times(x):  # rounded once, as OpenCV's fused multiply-add
        return (1.0 - s.astype(np.float64) * x).astype(f32)

    tab = np.stack([v, v * one_minus_s_times(one), v * one_minus_s_times(h),
                    v * one_minus_s_times(one - h)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    return np.where((s == 0)[..., None], v[..., None], bgr) * f32(255.0)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180)) (H, W, 3) → uint8 BGR.  OpenCV converts
    each row in vector steps of 32 pixels, truncating the result, and the
    last W mod 32 pixels one by one, rounding it to nearest."""
    bgr = _hsv_to_bgr_f32(hsv)
    vec = hsv.shape[1] - hsv.shape[1] % _HSV_BLOCK
    bgr[:, :vec] = np.trunc(bgr[:, :vec])
    bgr[:, vec:] = np.rint(bgr[:, vec:])
    return np.clip(bgr, 0, 255).astype(np.uint8)
