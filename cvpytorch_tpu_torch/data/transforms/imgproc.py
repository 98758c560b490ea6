"""OpenCV 5.0.0's uint8 image operations that the host transforms use, in
numpy, to the bit (``cv2`` is not on the card's machine).  Below; then the
warps (``warp_affine``, ``warp_perspective``, ``rotation_matrix_2d``),
``resize_area``, ``gaussian_blur``, ``median_blur``, ``bgr_to_gray``,
``equalize_hist``, ``clahe``, the 8-bit Lab pair and ``fill_poly``, each
described where it is defined.

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


def _linear_taps(n_in: int, n_out: int, clamp: bool, factor: float | None = None):
    """Source index and 11-bit weights of each output position, as
    OpenCV's ``resize`` computes them; ``clamp`` is the horizontal rule
    (an out-of-range source takes the edge pixel with weight 1).
    ``factor``: the ``fx``/``fy`` OpenCV was given instead of a size."""
    scale = 1.0 / (factor if factor is not None else n_out / n_in)
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


def _is_exact_half(n_in: int, n_out: int, factor: float | None = None) -> bool:
    scale = 1.0 / (factor if factor is not None else n_out / n_in)
    return abs(scale - 2) < np.finfo(np.float64).eps


def resize_linear(img: np.ndarray, size: tuple[int, int] | None, rows: slice | None = None,
                  cols: slice | None = None, fxy: float | None = None) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → (h, w[, C]) for ``size`` = (h, w), or
    its ``rows`` × ``cols`` window.  ``fxy`` (``size`` None) is
    ``cv2.resize(img, None, fx=fxy, fy=fxy)``: the size is the rounded
    H·fxy × W·fxy and the source positions step by 1 / fxy, not by the
    ratio of the sizes."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, not {img.dtype}")
    H, W = img.shape[:2]
    oh, ow = size if size is not None else (int(np.rint(H * fxy)), int(np.rint(W * fxy)))
    ys, xs = _window(oh, rows), _window(ow, cols)
    if (oh, ow) == (H, W) and (fxy is None or fxy == 1.0):
        return np.ascontiguousarray(img[ys[:, None], xs[None, :]])
    if _is_exact_half(H, oh, fxy) and _is_exact_half(W, ow, fxy):
        # OpenCV's 2×2 area mean on the window's source block: row pairs,
        # then column pairs
        block = img[2 * ys[0]:2 * ys[-1] + 2, 2 * xs[0]:2 * xs[-1] + 2]
        pairs = block.reshape(len(ys), 2, -1)
        r = (pairs[:, 0].astype(np.uint16) + pairs[:, 1]).reshape(len(ys), len(xs), 2, -1)
        out = r[:, :, 0] + r[:, :, 1]
        out += 2
        out >>= 2
        return out.astype(np.uint8).reshape((len(ys), len(xs)) + img.shape[2:])
    sx, a0, a1 = (t[xs] for t in _linear_taps(W, ow, clamp=True, factor=fxy))
    sy, b0, b1 = (t[ys] for t in _linear_taps(H, oh, clamp=False, factor=fxy))
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


# ---------------------------------------------------------------------------
# Warps.  OpenCV 5's ``warpAffine``/``warpPerspective`` on uint8 compute in
# float32: the inverse map (inverted in double, then rounded to float32),
# the source coordinate of each output pixel, ``floor`` and the fractions,
# then the two horizontal lerps and the vertical one, each a fused
# multiply-add, rounded to nearest even.  The coordinates are computed one
# way in the vector body of a row (``fma(M0, x, M1·y + M2)`` with the
# product and the sum each rounded) and another in its scalar tail, the
# last ``dst_w mod _WARP_BLOCK`` pixels (``fma(x, M0, y·M1) + M2``).
# A source pixel outside the image is the border value, blended like any
# other (BORDER_CONSTANT).
# ---------------------------------------------------------------------------

_WARP_BLOCK = 16  # float32 lanes of OpenCV's AVX-512 warp kernels (x86-64)
_F32, _F64 = np.float32, np.float64


def _fma32(a, b, c):
    """float32 ``fma(a, b, c)``: the product of two float32 values is exact
    in float64, and so is the sum wherever the operands' bits span at most
    53 (every case of the warps but sums with near-zero fractions, where a
    float64 rounding could land on a float32 tie: not seen in the tests)."""
    return (np.asarray(a, _F64) * b + c).astype(_F32)


def _invert_affine(M) -> np.ndarray:
    """OpenCV's inversion of a 2×3 forward map in double (warpAffine
    without WARP_INVERSE_MAP), rounded to float32 as its kernels take it."""
    m = np.asarray(M, _F64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(_F32)


def _invert_3x3(M) -> np.ndarray:
    """OpenCV's closed-form 3×3 inverse (``invert`` with DECOMP_LU, n = 3),
    in double, rounded to float32."""
    s = np.asarray(M, _F64).reshape(3, 3)
    det = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
           - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
           + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    d = 1.0 / det if det != 0 else 0.0
    t = np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
        (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
        (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
        (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
        (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d])
    return t.astype(_F32)


def _warp_coord(m0, m1, m2, x, y, tail):
    """m0·x + m1·y + m2 in float32 as OpenCV's vector body (``tail`` False)
    or scalar tail (True) computes it; x, y broadcast."""
    if tail:
        return (_fma32(x, m0, (_F32(m1) * y).astype(_F32)) + _F32(m2)).astype(_F32)
    return _fma32(m0, x, ((_F32(m1) * y).astype(_F32) + _F32(m2)).astype(_F32))


def _coords(coefs, x, y, body):
    """Coordinates over x (1, w) and y (h, 1): the vector body for the
    first ``body`` columns, the scalar tail after."""
    parts = [_warp_coord(*coefs, x[:, :body], y, False),
             _warp_coord(*coefs, x[:, body:], y, True)]
    shape = np.broadcast_shapes(x.shape, y.shape)
    return np.concatenate([np.broadcast_to(p, shape[:1] + p.shape[1:]) for p in parts], 1)


def _border_pad(img, border_value):
    """(H, W, C) image framed by one pixel of the border value, so that a
    tap index clipped to [-1, H] × [-1, W] (then + 1) reads it."""
    H, W, C = img.shape
    pad = np.empty((H + 2, W + 2, C), img.dtype)
    value = np.asarray(_border(border_value, C), img.dtype)
    pad[0] = pad[-1] = value
    pad[:, 0] = pad[:, -1] = value
    pad[1:-1, 1:-1] = img
    return pad


def _border(border_value, C):
    """OpenCV's Scalar of ``border_value`` for C channels (a scalar s is
    (s, 0, 0, 0))."""
    given = np.atleast_1d(np.asarray(border_value, _F64))[:C]
    v = np.zeros(C)
    v[:len(given)] = given
    return np.clip(np.rint(v), 0, 255)


# float32 lerps without fusing stay within 1e-4 of the fused ones for values
# in [0, 255]; a result that far from a tie rounds the same
_TIE_MARGIN = _F32(2.0 ** -10)


def _lerp_rows(a, p0, p1):
    """The horizontal step unfused in float32, straight from uint8."""
    out = np.subtract(p1, p0, dtype=_F32)
    out *= a
    out += p0
    return out


def _lerp(a, b, i0, i1, taps):
    """OpenCV's bilinear step: two horizontal fused multiply-adds on the
    fraction ``a``, one vertical on ``b``, then round half to even.  It is
    computed in float32 unfused from the horizontal results ``i0``/``i1``
    (``_lerp_rows``), and again fused (in float64) where the result lies
    within ``_TIE_MARGIN`` of a tie, from ``taps(flat indices)``: the four
    source values (top-left, top-right, bottom-left, bottom-right) there."""
    out = i1 - i0
    out *= b
    out += i0
    r = np.rint(out)
    out -= r
    near = np.flatnonzero(np.abs(out, out=out) > _F32(0.5) - _TIE_MARGIN)
    if len(near):
        at = np.unravel_index(near, r.shape)
        an, bn = (v[tuple(i if n > 1 else 0 for i, n in zip(at, v.shape))]
                  for v in (a, b))
        f = [p.astype(_F32) for p in taps(near)]
        e0 = _fma32(an, f[1] - f[0], f[0])
        e1 = _fma32(an, f[3] - f[2], f[2])
        r.reshape(-1)[near] = np.rint(_fma32(bn, e1 - e0, e0))
    return r.astype(np.uint8)


def _as_hwc(img):
    if img.dtype != np.uint8:
        raise TypeError(f"the warps take uint8 images, not {img.dtype}")
    return img if img.ndim == 3 else img[..., None]


def _sample(img, sx, sy, border_value, interpolation):
    """Sample the uint8 (H, W, C) image at float32 source coordinates
    (h, w), or a row (1, w) of x and a column (h, 1) of y, which the
    separable path passes: its gathers are then by rows and columns."""
    H, W, C = img.shape
    pad = _border_pad(img, border_value)
    if interpolation == "nearest":
        ix = np.clip(np.rint(sx), -1, W).astype(np.int64) + 1
        iy = np.clip(np.rint(sy), -1, H).astype(np.int64) + 1
        if sx.shape[0] == 1 and sy.shape[1] == 1:
            return pad[iy[:, 0]][:, ix[0]]
        return pad[iy, ix]
    if interpolation != "linear":
        raise ValueError(f"interpolation {interpolation!r}: 'linear' or 'nearest'")
    fx, fy = np.floor(sx), np.floor(sy)
    a = (sx - fx).astype(_F32)[..., None]
    b = (sy - fy).astype(_F32)[..., None]
    x0 = np.clip(fx, -1, W).astype(np.int64) + 1
    x1 = np.clip(fx + 1, -1, W).astype(np.int64) + 1
    y0 = np.clip(fy, -1, H).astype(np.int64) + 1
    y1 = np.clip(fy + 1, -1, H).astype(np.int64) + 1
    if sx.shape[0] == 1 and sy.shape[1] == 1:
        # the horizontal step once on each source row that output rows
        # need, its columns as (row, x·C + channel) with np.take; then
        # the vertical step on the rows each output row takes
        need, pos = np.unique(np.concatenate([y0[:, 0], y1[:, 0]]), return_inverse=True)
        rows = pad[need].reshape(len(need), -1)
        chan = np.arange(C)
        c0, c1 = ((c[0][:, None] * C + chan).ravel() for c in (x0, x1))
        a = np.repeat(a.reshape(-1), C)[None, :]
        horiz = _lerp_rows(a, np.take(rows, c0, axis=1), np.take(rows, c1, axis=1))
        h = len(y0)
        top, bottom = pos[:h], pos[h:]

        def taps(i):
            r, c = i // len(c0), i % len(c0)
            return [rows[top[r], c0[c]], rows[top[r], c1[c]],
                    rows[bottom[r], c0[c]], rows[bottom[r], c1[c]]]

        out = _lerp(a, b.reshape(-1, 1), horiz[top], horiz[bottom], taps)
        return out.reshape(h, -1, C)
    flat = pad.reshape(-1, C)
    w2 = W + 2
    p = [flat[y * w2 + x] for y in (y0, y1) for x in (x0, x1)]
    return _lerp(a, b, _lerp_rows(a, p[0], p[1]), _lerp_rows(a, p[2], p[3]),
                 lambda i: [q.reshape(-1)[i] for q in p])


def warp_affine(img: np.ndarray, M, dsize: tuple[int, int], border_value=0,
                interpolation: str = "linear") -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR|INTER_NEAREST,
    borderValue=border_value)`` on uint8 (H, W) or (H, W, C): ``M`` is the
    forward 2×3 map and ``dsize`` is (w, h), as OpenCV takes them.  Equal
    to OpenCV 5.0.0 (x86-64, AVX-512 dispatch); nearest rounds the source
    coordinate half to even.  Where the map has no rotation or shear (the
    inverse's off-diagonal terms exactly 0), x depends on the column alone
    and y on the row alone, and the same floats come from a separable
    gather by rows and columns."""
    out_2d = img.ndim == 2 or img.shape[2] == 1  # as OpenCV returns it
    img = _as_hwc(img)
    w, h = int(dsize[0]), int(dsize[1])
    m = _invert_affine(M)
    x = np.arange(w, dtype=_F32)[None, :]
    y = np.arange(h, dtype=_F32)[:, None]
    body = w - w % _WARP_BLOCK
    if m[1] == 0 and m[3] == 0:
        sx = _coords(m[0:3], x, np.zeros((1, 1), _F32), body)
        sy = _coords(m[3:6], np.zeros((1, w), _F32), y, body)[:, :1]
    else:
        sx = _coords(m[0:3], x, y, body)
        sy = _coords(m[3:6], x, y, body)
    out = _sample(img, sx, sy, border_value, interpolation)
    return out[..., 0] if out_2d else out


def warp_perspective(img: np.ndarray, M, dsize: tuple[int, int], border_value=0,
                     interpolation: str = "linear") -> np.ndarray:
    """``cv2.warpPerspective`` on uint8, as ``warp_affine``: the 3×3 map
    inverted in double, source x = X / W and y = Y / W in float32, each of
    X, Y, W computed as ``warp_affine``'s coordinates."""
    out_2d = img.ndim == 2 or img.shape[2] == 1  # as OpenCV returns it
    img = _as_hwc(img)
    w, h = int(dsize[0]), int(dsize[1])
    m = _invert_3x3(M)
    x = np.arange(w, dtype=_F32)[None, :]
    y = np.arange(h, dtype=_F32)[:, None]
    body = w - w % _WARP_BLOCK
    X, Y, Wc = (_coords(m[i:i + 3], x, y, body) for i in (0, 3, 6))
    with np.errstate(divide="ignore", invalid="ignore"):
        sx, sy = X / Wc, Y / Wc
    out = _sample(img, sx, sy, border_value, interpolation)
    return out[..., 0] if out_2d else out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the center rounded to float32 (a
    Point2f), the angle in degrees turned to radians as ``angle·(π/180)``,
    the rest in double."""
    cx, cy = (float(_F32(c)) for c in center)
    r = angle * (np.pi / 180)
    alpha, beta = np.cos(r) * scale, np.sin(r) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _area_taps(n_in: int, n_out: int):
    """OpenCV's ``computeResizeAreaTab``: for each output position its
    source indices and float32 weights, in OpenCV's order (the left
    partial cell, the whole cells, the right partial cell), padded with
    zero weights to a common count."""
    scale = n_in / n_out
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        t = []
        if s1 - f1 > 1e-3:
            t.append((s1 - 1, (s1 - f1) / cell))
        t += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            t.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(t)
    k = max(len(t) for t in taps)
    idx = np.zeros((n_out, k), np.int64)
    wgt = np.zeros((n_out, k), _F32)
    for d, t in enumerate(taps):
        for j, (s, w) in enumerate(t):
            idx[d, j], wgt[d, j] = s, w
    return idx, wgt


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(..., INTER_AREA)`` on uint8 (H, W[, C]) to a size no
    larger on either axis, ``size`` = (h, w).  Integer factors on both axes
    average their cells as OpenCV does (2×2: ``(a + b + c + d + 2) >> 2``;
    others: the integer sum times float32 1/area, rounded half to even);
    other factors accumulate float32 cell weights, row by row, in
    OpenCV's order, and round the sum half to even."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8 images, not {img.dtype}")
    H, W = img.shape[:2]
    oh, ow = size
    if oh > H or ow > W:
        raise ValueError("resize_area only shrinks; use resize_linear to enlarge")
    if (oh, ow) == (H, W):
        return img.copy()
    sy, sx = H / oh, W / ow
    if sx == int(sx) and sy == int(sy):
        fy, fx = int(sy), int(sx)
        if (fy, fx) == (2, 2):
            return resize_linear(img, size)
        block = img[:oh * fy, :ow * fx].reshape((oh, fy, ow, fx) + img.shape[2:])
        total = block.sum(axis=(1, 3), dtype=np.int32).astype(_F32)
        total *= _F32(1.0) / _F32(fy * fx)
        return np.rint(total).astype(np.uint8)
    xi, xw = _area_taps(W, ow)
    yi, yw = _area_taps(H, oh)
    src = img.reshape(H, W, -1)
    rows = np.zeros((H, ow, src.shape[2]), _F32)
    for j in range(xi.shape[1]):  # buf[d] += S[s]·alpha, rounded each step
        rows += src[:, xi[:, j]] * xw[:, j, None]
    out = rows[yi[:, 0]] * yw[:, 0, None, None]
    for j in range(1, yi.shape[1]):  # sum += beta·buf
        out += rows[yi[:, j]] * yw[:, j, None, None]
    return np.rint(out).astype(np.uint8).reshape((oh, ow) + img.shape[2:])


# OpenCV's bit-exact Gaussian kernels for sigma = 0 (``small_gaussian_tab``)
# as 8-bit fixed point
_GAUSS_FIXED = {1: [256], 3: [64, 128, 64], 5: [16, 64, 96, 64, 16],
                7: [8, 28, 56, 72, 56, 28, 8]}


def _reflect101(n: int, r: int) -> np.ndarray:
    i = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def gaussian_blur(img: np.ndarray, ksize: int = 5) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` on uint8 for k in 1, 3, 5, 7:
    OpenCV's fixed-point path (kernel weights in 1/256, the horizontal sums
    exact, the vertical sums exact in 1/65536, rounded half up) with
    BORDER_REFLECT_101."""
    if img.dtype != np.uint8:
        raise TypeError(f"gaussian_blur takes uint8 images, not {img.dtype}")
    if ksize not in _GAUSS_FIXED:
        raise ValueError(f"gaussian_blur supports ksize 1, 3, 5, 7, not {ksize}")
    k = np.asarray(_GAUSS_FIXED[ksize], np.int32)
    r = ksize // 2
    H, W = img.shape[:2]
    src = img.astype(np.int32)
    cols = src[:, _reflect101(W, r)]
    horiz = sum(k[j] * cols[:, j:j + W] for j in range(ksize))
    rows = horiz[_reflect101(H, r)]
    total = sum(k[j] * rows[j:j + H] for j in range(ksize))
    return ((total + (1 << 15)) >> 16).astype(np.uint8)


def _odd_even_merge_sort(n: int):
    """Batcher's odd-even merge sort network on ``n`` (a power of 2)
    positions, as (i, j) compare-exchanges in order (min to i)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _median_network(count: int):
    """The compare-exchanges of a sort of ``count`` values that the middle
    one depends on: Batcher's network on the next power of two, the pads
    taken as +inf (their exchanges relabel or do nothing), pruned back
    from the middle position.  Returns (steps, inputs): each step is
    (i, j, need_min, need_max), and the median ends at position
    ``count // 2``."""
    n = 1 << (count - 1).bit_length()
    inf = set(range(count, n))
    steps = []
    for i, j in _odd_even_merge_sort(n):
        if j in inf:
            continue  # min(x, inf) = x stays; inf stays at j
        if i in inf:  # the finite value moves down, inf up: relabel
            inf.discard(i)
            inf.add(j)
            steps.append((i, j, "swap"))
            continue
        steps.append((i, j, "cmp"))
    needed, kept = {count // 2}, []
    for i, j, kind in reversed(steps):
        if i not in needed and j not in needed:
            continue
        if kind == "swap":  # position i takes j's value, j becomes inf
            if i in needed:
                needed.discard(i)
                needed.add(j)
            kept.append((i, j, kind, False, False))
            continue
        need_min, need_max = i in needed, j in needed
        needed |= {i, j}
        kept.append((i, j, kind, need_min, need_max))
    return kept[::-1]


_MEDIAN_NETWORKS = {k: _median_network(k * k) for k in (3, 5)}


def median_blur(img: np.ndarray, ksize: int = 5) -> np.ndarray:
    """``cv2.medianBlur`` on uint8 for ksize 3 or 5: the median of each
    ksize × ksize window with BORDER_REPLICATE, by a pruned sorting network
    of elementwise minima and maxima over the window's shifted views."""
    if img.dtype != np.uint8:
        raise TypeError(f"median_blur takes uint8 images, not {img.dtype}")
    if ksize not in _MEDIAN_NETWORKS:
        raise ValueError(f"median_blur supports ksize 3 and 5, not {ksize}")
    r = ksize // 2
    H, W = img.shape[:2]
    yi = np.clip(np.arange(-r, H + r), 0, H - 1)
    xi = np.clip(np.arange(-r, W + r), 0, W - 1)
    pad = img[yi][:, xi]
    vals = {dy * ksize + dx: pad[dy:dy + H, dx:dx + W]
            for dy in range(ksize) for dx in range(ksize)}
    for i, j, kind, need_min, need_max in _MEDIAN_NETWORKS[ksize]:
        if kind == "swap":
            vals[i], vals[j] = vals.get(j), None
            continue
        a, b = vals[i], vals[j]
        vals[i] = np.minimum(a, b) if need_min else None
        vals[j] = np.maximum(a, b) if need_max else None
    return np.ascontiguousarray(vals[ksize * ksize // 2])


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``COLOR_BGR2GRAY`` on uint8 as OpenCV 5.0.0 computes it: 15-bit
    integer weights (3735, 19235, 9798), rounded half up; equal over all
    2^24 colours (OpenCV 4's 14-bit weights are not)."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def equalize_hist(img: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` on a uint8 single-channel image: the lookup
    table ``round(cumsum · 255 / (N − h[first]))`` in float32 from the
    first occupied bin on."""
    hist = np.bincount(img.ravel(), minlength=256)
    first = int(np.flatnonzero(hist)[0])
    total = img.size
    if hist[first] == total:
        return np.full_like(img, first)
    scale = _F32(255.0) / _F32(total - hist[first])
    lut = np.zeros(256, np.uint8)
    csum = np.cumsum(hist[first + 1:])
    lut[first + 1:] = np.clip(np.rint(csum.astype(_F32) * scale), 0, 255)
    return lut[img]


def clahe(img: np.ndarray, clip_limit: float = 40.0,
          tile_grid: tuple[int, int] = (8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tile_grid).apply`` on a uint8 (H, W)
    image: each tile's histogram (the image padded with BORDER_REFLECT_101
    to a whole number of tiles) clipped at ``int(clip·area/256)`` with the
    excess spread as OpenCV spreads it, its float32 cumulative lookup
    table, then the bilinear blend of the four nearest tiles' tables in
    float32, rounded half to even.  Where either side does not divide by
    its tile count, OpenCV pads both sides by ``tiles − side mod tiles``
    (a whole tile on a side that divides)."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise TypeError("clahe takes a uint8 (H, W) image")
    tx, ty = int(tile_grid[0]), int(tile_grid[1])
    H, W = img.shape
    src = img
    if H % ty or W % tx:
        # OpenCV pads both axes then, an axis that divides by a whole tile
        src = img[_reflect101(H, ty)[ty:2 * ty + H - H % ty]]
        src = src[:, _reflect101(W, tx)[tx:2 * tx + W - W % tx]]
    th, tw = src.shape[0] // ty, src.shape[1] // tx
    area = th * tw
    tiles = src[:ty * th, :tx * tw].reshape(ty, th, tx, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(ty * tx, area)
    offsets = (np.arange(ty * tx) * 256)[:, None]
    hist = np.bincount((tiles + offsets).ravel(),
                       minlength=ty * tx * 256).reshape(ty * tx, 256)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        residual = clipped % 256
        for t in np.flatnonzero(residual):
            step = max(256 // int(residual[t]), 1)
            hist[t, np.arange(0, 256, step)[:residual[t]]] += 1
    scale = _F32(255.0) / _F32(area)
    lut = np.clip(np.rint(np.cumsum(hist, 1).astype(_F32) * scale), 0, 255)
    lut = lut.astype(_F32).reshape(ty, tx, 256)

    def axis(n, tile, tiles_n):
        f = np.arange(n, dtype=_F32) * (_F32(1.0) / _F32(tile)) - _F32(0.5)
        i1 = np.floor(f).astype(np.int64)
        frac = (f - i1).astype(_F32)
        return np.maximum(i1, 0), np.minimum(i1 + 1, tiles_n - 1), frac

    y1, y2, ya = axis(H, th, ty)
    x1, x2, xa = axis(W, tw, tx)
    xa1, ya1 = _F32(1) - xa, (_F32(1) - ya)[:, None]
    ya = ya[:, None]
    v = img
    left = lut[y1[:, None], x1[None, :], v] * xa1 + lut[y1[:, None], x2[None, :], v] * xa
    right = lut[y2[:, None], x1[None, :], v] * xa1 + lut[y2[:, None], x2[None, :], v] * xa
    return np.clip(np.rint(left * ya1 + right * ya), 0, 255).astype(np.uint8)


# OpenCV's 8-bit Lab conversions (sRGB, D65) run on integer tables.  The
# tables here are built in double, where OpenCV builds them in soft float:
# BGR2Lab differs from OpenCV 5.0.0 by 1 in a and b on 3.3e-5 of all 2^24
# colours; Lab2BGR, whose tables this copy reconstructs less closely,
# differs on 1.9 % of all 2^24 Lab triples, by 1 (2 on 32 triples).
_D65 = np.array([0.950456, 1.0, 1.088754])
_SRGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
_XYZ2SRGB = np.array([[3.240479, -1.53715, -0.498535],
                      [-0.969256, 1.875991, 0.041556],
                      [0.055648, -0.204043, 1.057311]])
_LAB_SHIFT, _LAB_SHIFT2, _LAB_BASE = 12, 15, 1 << 14


def _lab_tables():
    x = np.arange(256) / 255.0
    gamma = np.rint(255 * 8 * np.where(x <= 0.04045, x / 12.92,
                                       ((x + 0.055) / 1.055) ** 2.4)).astype(np.int64)
    c = np.arange(256 * 3 // 2 * 8) / (255.0 * 8)
    cbrt = np.rint((1 << _LAB_SHIFT2) * np.where(c < 216 / 24389, c * (841 / 108) + 16 / 116,
                                                  np.cbrt(c))).astype(np.int64)
    to_xyz = np.rint((1 << _LAB_SHIFT) * _SRGB2XYZ / _D65[:, None]).astype(np.int64)
    L = np.arange(256) * 100 / 255
    small = L <= 8
    y = np.where(small, L * 27 / 24389, ((L + 16) / 116) ** 3)
    fy = np.where(small, y * (841 / 108) + 16 / 116, (L + 16) / 116)
    y_tab = np.rint(y * _LAB_BASE).astype(np.int64)
    fy_tab = np.rint(fy * _LAB_BASE).astype(np.int64)
    to_rgb = np.rint((1 << _LAB_SHIFT) * _XYZ2SRGB * _D65[None, :]).astype(np.int64)
    g = np.arange(4096) / 4096
    inv_gamma = np.rint(255 * np.where(g <= 0.0031308, 12.92 * g,
                                       1.055 * g ** (1 / 2.4) - 0.055)).astype(np.int64)
    return gamma, cbrt, to_xyz, y_tab, fy_tab, to_rgb, inv_gamma


(_GAMMA_TAB, _CBRT_TAB, _TO_XYZ, _Y_TAB, _FY_TAB, _TO_RGB,
 _INV_GAMMA_TAB) = _lab_tables()


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def bgr_to_lab(img: np.ndarray) -> np.ndarray:
    """``COLOR_BGR2LAB`` on uint8 (L·255/100, a + 128, b + 128), OpenCV's
    integer path: sRGB gamma table, 12-bit XYZ weights, cube-root table."""
    rgb = [_GAMMA_TAB[img[..., k]] for k in (2, 1, 0)]
    fx, fy, fz = (_CBRT_TAB[_descale(sum(w * c for w, c in zip(row, rgb)), _LAB_SHIFT)]
                  for row in _TO_XYZ)
    one = 1 << _LAB_SHIFT2
    L = _descale((116 * 255 + 50) // 100 * fy - (16 * 255 * one + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * one, _LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * one, _LAB_SHIFT2)
    return np.clip(np.stack([L, a, b], -1), 0, 255).astype(np.uint8)


def lab_to_bgr(lab: np.ndarray) -> np.ndarray:
    """``COLOR_LAB2BGR`` on uint8, after OpenCV's integer path: Y and f(Y)
    tables in 1/2^14, a/500 and b/200 by integer division, the inverse of
    f, 12-bit sRGB weights, a 4096-entry inverse gamma table."""
    L, a, b = (lab[..., k].astype(np.int64) for k in range(3))
    y, fy = _Y_TAB[L], _FY_TAB[L]
    base = _LAB_BASE

    def f_inv(t):
        t = t / base
        return np.rint(np.where(t < 6 / 29, (t - 16 / 116) * (108 / 841), t ** 3)
                       * base).astype(np.int64)

    x = f_inv(fy + a * base // 500 - 128 * base // 500)
    z = f_inv(fy - (b * base // 200 - 128 * base // 200))
    shift = _LAB_SHIFT + 2
    out = [_INV_GAMMA_TAB[np.clip(_descale(r[0] * x + r[1] * y + r[2] * z, shift), 0, 4095)]
           for r in _TO_RGB]
    return np.stack(out[::-1], -1).astype(np.uint8)


_XY_SHIFT = 16  # drawing.cpp's fixed point for the fill's edge x


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """drawing.cpp's clipLine(Size2l, Point2l&, Point2l&): the segment
    clipped to [0, w) x [0, h) in double, truncated; → (inside, x1, y1,
    x2, y2), the points as clipLine leaves them even when it fails."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_points(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels of LineIterator(img, pt1, pt2, 8, leftToRight=true):
    endpoints clipped when either lies outside, then Bresenham from the
    left end (the major axis steps every pixel, the minor one when the
    error goes negative: k_i = ceil((2 i minor - major) / (2 major)))."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    k = np.maximum(-((major - 2 * i * minor) // (2 * major)), 0) if major else i
    if dy > dx:
        return x1 + k, y1 + sy * i
    return x1 + i, y1 + sy * k


def fill_poly(mask: np.ndarray, pts, value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(mask, [pts], value)`` on an (H, W) array, in place:
    integer vertices, LINE_8, no shift, as OpenCV 5.0.0 draws it.  Every
    edge is first drawn as an 8-connected line (``_line_points``); then a
    scanline fill over each edge's rows y0 <= y < y1, its x in 16.16 fixed
    point stepping by dx = floor(Δx / Δy) from its upper end.  An edge with
    an end outside the canvas runs along its clipped segment
    (``_clip_line``) extended over its rows; one that clips to a single
    point stands at that point's x; one wholly outside keeps its own line.
    On each row the sorted crossings pair up and fill x_a <= i <= x_b.
    Returns ``mask``."""
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    H, W = mask.shape[:2]
    lines_x, lines_y, edges = [], [], []
    for i in range(len(v)):
        (x0, y0), (x1, y1) = v[i - 1].tolist(), v[i].tolist()
        lx, ly = _line_points(W, H, x0, y0, x1, y1)
        lines_x.append(lx)
        lines_y.append(ly)
        if y0 == y1:
            continue
        top, bottom = min(y0, y1), max(y0, y1)
        p0x, p0y, p1x, p1y = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
        if not (0 <= x0 < W and 0 <= x1 < W and 0 <= y0 < H and 0 <= y1 < H):
            inside, cx0, cy0, cx1, cy1 = _clip_line(W, H, x0, y0, x1, y1)
            if inside and cy0 == cy1:
                edges.append((top, bottom, cx0 << _XY_SHIFT, 0))
                continue
            if inside:
                p0x, p0y, p1x, p1y = cx0 << _XY_SHIFT, cy0, cx1 << _XY_SHIFT, cy1
        dx = (p1x - p0x) // (p1y - p0y)
        ax, ay = (p0x, p0y) if p0y < p1y else (p1x, p1y)
        edges.append((top, bottom, ax + (top - ay) * dx, dx))
    mask[np.concatenate(lines_y), np.concatenate(lines_x)] = value
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    ey0, ey1, ex, edx = e.T
    ex1 = ex + (ey1 - ey0) * edx
    if (ey1.max() < 0 or ey0.min() >= H or max(ex.max(), ex1.max()) < 0
            or min(ex.min(), ex1.min()) >= W << _XY_SHIFT):
        return mask
    lo, hi = np.maximum(ey0, 0), np.minimum(ey1, H)
    n = np.maximum(hi - lo, 0)
    if not n.sum():
        return mask
    idx = np.repeat(np.arange(len(e)), n)
    y = lo[idx] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    x = ex[idx] + (y - ey0[idx]) * edx[idx]
    order = np.lexsort((x, y))
    y, x = y[order].reshape(-1, 2)[:, 0], x[order].reshape(-1, 2)
    xa = (x[:, 0] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    xb = x[:, 1] >> _XY_SHIFT
    keep = (xa < W) & (xb >= 0)
    y, xa, xb = y[keep], np.maximum(xa[keep], 0), np.minimum(xb[keep], W - 1)
    keep = xa <= xb
    y, xa, xb = y[keep], xa[keep], xb[keep]
    if not len(y):
        return mask
    r0, r1 = int(y.min()), int(y.max()) + 1
    runs = np.zeros((r1 - r0, W + 1), np.int32)
    np.add.at(runs, (y - r0, xa), 1)
    np.add.at(runs, (y - r0, xb + 1), -1)
    mask[r0:r1][np.cumsum(runs[:, :W], axis=1) > 0] = value
    return mask
