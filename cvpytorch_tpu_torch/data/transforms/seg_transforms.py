"""Segmentation transforms (counterpart of
``cvpytorch_tpu/data/transforms/seg_transforms.py``).  Samples are
``{'image': HWC uint8 BGR, 'target': HW uint8 mask or None}``; masks are
resized with OpenCV's nearest rule and padded with ``ignore_label`` (255).

The JAX transforms call OpenCV; these call ``imgproc``, which computes
OpenCV's uint8 resize and HSV conversions in numpy, and draw from Python's
``random`` in the same order, so a seeded run gives the same samples.
``RandomScaleCrop`` resizes only the window it crops (the crop's corner
depends on the resized size alone), which is the crop of the full resize.
``RandomRotate`` warps the image bilinear and the mask nearest on
``imgproc.warp_affine``.  ``RandAugment`` does in numpy what the JAX
transform asks of PIL (``PIL_OPS`` below), to PIL's integer and float
arithmetic.
"""
from __future__ import annotations

import math
import random

import numpy as np

from .imgproc import (bgr_to_hsv, hsv_to_bgr, resize_linear, resize_nearest,
                      rotation_matrix_2d, warp_affine)


def _pad(arr: np.ndarray, ph: int, pw: int, value) -> np.ndarray:
    """Bottom and right padding with a constant, as
    ``cv2.copyMakeBorder(..., BORDER_CONSTANT)``."""
    if not (ph or pw):
        return arr
    widths = ((0, ph), (0, pw)) + ((0, 0),) * (arr.ndim - 2)
    return np.pad(arr, widths, constant_values=value)


class Resize:
    """To ``size`` (h, w): the image bilinear, the mask nearest.
    ``keep_ratio`` is accepted and ignored, as in the JAX transform."""

    def __init__(self, size, keep_ratio=False):
        self.size = tuple(size)
        self.keep_ratio = keep_ratio

    def __call__(self, sample):
        sample["image"] = resize_linear(sample["image"], self.size)
        if sample.get("target") is not None:
            sample["target"] = resize_nearest(np.asarray(sample["target"]), self.size)
        return sample


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            sample["image"] = np.ascontiguousarray(sample["image"][:, ::-1])
            if sample.get("target") is not None:
                sample["target"] = np.ascontiguousarray(sample["target"][:, ::-1])
        return sample


class RandomScaleCrop:
    """Scale by s ~ U(scale), pad to at least ``size`` (image 0, mask
    ``ignore_label``), crop ``size`` at a random corner."""

    def __init__(self, size, scale=(0.5, 2.0), ignore_label=255):
        self.size = tuple(size)
        self.scale = scale
        self.ignore_label = ignore_label

    def __call__(self, sample):
        img, mask = sample["image"], sample.get("target")
        s = random.uniform(*self.scale)
        nh, nw = int(img.shape[0] * s), int(img.shape[1] * s)
        ch, cw = self.size
        y0 = random.randint(0, max(nh, ch) - ch)
        x0 = random.randint(0, max(nw, cw) - cw)
        rows, cols = slice(y0, min(y0 + ch, nh)), slice(x0, min(x0 + cw, nw))
        ph, pw = ch - (rows.stop - rows.start), cw - (cols.stop - cols.start)
        sample["image"] = _pad(resize_linear(img, (nh, nw), rows, cols), ph, pw, 0)
        if mask is not None:
            sample["target"] = _pad(resize_nearest(np.asarray(mask), (nh, nw), rows, cols),
                                    ph, pw, self.ignore_label)
        return sample


class RandomScaleResize:
    def __init__(self, size, scale=(0.5, 2.0)):
        self.size = tuple(size)
        self.scale = scale

    def __call__(self, sample):
        s = random.uniform(*self.scale)
        h, w = int(self.size[0] * s), int(self.size[1] * s)
        return Resize((h, w))(sample)


class RandomCrop:
    def __init__(self, size, ignore_label=255):
        self.size = tuple(size)
        self.ignore_label = ignore_label

    def __call__(self, sample):
        ch, cw = self.size
        img = sample["image"]
        ph, pw = max(ch - img.shape[0], 0), max(cw - img.shape[1], 0)
        img = sample["image"] = _pad(img, ph, pw, 0)
        if sample.get("target") is not None:
            sample["target"] = _pad(np.asarray(sample["target"]), ph, pw, self.ignore_label)
        y0 = random.randint(0, img.shape[0] - ch)
        x0 = random.randint(0, img.shape[1] - cw)
        sample["image"] = img[y0:y0 + ch, x0:x0 + cw]
        if sample.get("target") is not None:
            sample["target"] = sample["target"][y0:y0 + ch, x0:x0 + cw]
        return sample


class Pad:
    def __init__(self, size, ignore_label=255):
        self.size = tuple(size)
        self.ignore_label = ignore_label

    def __call__(self, sample):
        img = sample["image"]
        ph = max(self.size[0] - img.shape[0], 0)
        pw = max(self.size[1] - img.shape[1], 0)
        sample["image"] = _pad(img, ph, pw, 0)
        if sample.get("target") is not None and (ph or pw):
            sample["target"] = _pad(np.asarray(sample["target"]), ph, pw, self.ignore_label)
        return sample


class PhotoMetricDistortion:
    """Brightness, contrast (before or after the HSV step), saturation and
    hue jitter on the image only.  ``p`` (``PhotoMetricDistortion: {p:
    0.5}`` in most seg configs) is accepted and unused: each step draws
    its own coin, as in the JAX transform, which takes no ``p``."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18, p=None):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, sample):
        img = sample["image"].astype(np.float32)
        if random.random() < 0.5:
            img += random.uniform(-self.brightness_delta, self.brightness_delta)
        mode = random.random() < 0.5
        if mode and random.random() < 0.5:
            img *= random.uniform(*self.contrast_range)
        img = np.clip(img, 0, 255).astype(np.uint8)
        hsv = bgr_to_hsv(img).astype(np.float32)
        if random.random() < 0.5:
            hsv[..., 1] *= random.uniform(*self.saturation_range)
        if random.random() < 0.5:
            hsv[..., 0] = (hsv[..., 0] + random.uniform(-self.hue_delta, self.hue_delta)) % 180
        hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
        img = hsv_to_bgr(hsv.astype(np.uint8))
        if not mode and random.random() < 0.5:
            img = np.clip(img.astype(np.float32) * random.uniform(*self.contrast_range),
                          0, 255).astype(np.uint8)
        sample["image"] = img
        return sample


class ColorJitter(PhotoMetricDistortion):
    """``PhotoMetricDistortion`` with fractional arguments (``p`` is
    accepted and unused, as in the JAX transform)."""

    def __init__(self, p=0.5, brightness=0.125, contrast=(0.5, 1.5),
                 saturation=(0.5, 1.5), hue=0.07):
        super().__init__(brightness_delta=brightness * 255,
                         contrast_range=contrast,
                         saturation_range=saturation,
                         hue_delta=hue * 180)


class RGB2BGR:
    def __call__(self, sample):
        sample["image"] = np.ascontiguousarray(sample["image"][..., ::-1])
        return sample


class ToTensor:
    """BGR→RGB float32 HWC /255; the mask becomes int32 (not scaled)."""

    def __call__(self, sample):
        img = sample["image"][..., ::-1]
        sample["image"] = np.ascontiguousarray(img, dtype=np.float32) / 255.0
        if sample.get("target") is not None:
            sample["target"] = np.asarray(sample["target"], dtype=np.int32)
        return sample


class RandomRotate:
    """With probability ``p``, a rotation by an angle drawn from
    ``degrees`` (a pair, or ±degrees) about the image centre: the image
    bilinear with a black border, the mask nearest with ``ignore_label``."""

    def __init__(self, degrees=10, p=0.5, ignore_label=255):
        self.degrees = degrees if isinstance(degrees, (list, tuple)) else (-degrees, degrees)
        self.p = p
        self.ignore_label = ignore_label

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"]
        h, w = img.shape[:2]
        angle = random.uniform(*self.degrees)
        m = rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
        sample["image"] = warp_affine(img, m, (w, h))
        if sample.get("target") is not None:
            sample["target"] = warp_affine(np.asarray(sample["target"]), m, (w, h),
                                           self.ignore_label, "nearest")
        return sample


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, sample):
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


# -- RandAugment ------------------------------------------------------------------
# PIL 12's operations on uint8 images in numpy: the ImageOps look-up tables,
# the ImageEnhance blends (C float, truncated), the 3×3 SMOOTH filter (float32,
# rounded; the border kept), the "L" conversion (16-bit fixed point) and the
# affine warps: bilinear as PIL's generic transform (sample centres, clamped
# taps, truncated), nearest as its fast paths (16.16 fixed point, or the
# scaling path's accumulated doubles).

def _apply_lut(img: np.ndarray, luts) -> np.ndarray:
    """``Image.point`` with one 256-entry table per channel, its entries
    clipped to [0, 255] as PIL clips them (equalize's can pass 255)."""
    tables = [np.clip(np.asarray(lut), 0, 255).astype(np.uint8) for lut in luts]
    if img.ndim == 2:
        return tables[0][img]
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = tables[c][img[..., c]]
    return out


def _channels(img):
    return [img] if img.ndim == 2 else [img[..., c] for c in range(img.shape[2])]


def _histogram(channel: np.ndarray) -> list:
    return np.bincount(channel.reshape(-1), minlength=256).tolist()


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)`` (cutoff 0)."""
    luts = []
    for ch in _channels(img):
        h = _histogram(ch)
        lo = next((i for i in range(256) if h[i]), 255)
        hi = next((i for i in range(255, -1, -1) if h[i]), 0)
        if hi <= lo:
            luts.append(list(range(256)))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(ix * scale + offset), 0), 255) for ix in range(256)])
    return _apply_lut(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``."""
    luts = []
    for ch in _channels(img):
        h = _histogram(ch)
        histo = [f for f in h if f]
        step = (sum(histo) - histo[-1]) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(list(range(256)))
            continue
        lut, n = [], step // 2
        for i in range(256):
            lut.append(n // step)
            n += h[i]
        luts.append(lut)
    return _apply_lut(img, luts)


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    mask = ~(2 ** (8 - bits) - 1)
    return _apply_lut(img, [[i & mask for i in range(256)]] * 3)


def point(img: np.ndarray, fn) -> np.ndarray:
    """``Image.point(fn)``: one table from ``fn`` for every channel."""
    return _apply_lut(img, [[fn(i) for i in range(256)]] * 3)


def blend(degenerate: np.ndarray, img: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(degenerate, img, alpha)``: in1 + alpha·(in2 − in1) in C
    float, truncated; outside alpha ∈ [0, 1] clipped to [0, 255] first."""
    a = np.float32(alpha)
    d = degenerate.astype(np.float32)
    t = d + a * (img.astype(np.float32) - d)
    if not 0.0 <= alpha <= 1.0:
        t = np.clip(t, 0, 255)
    return t.astype(np.uint8)


def to_luma(img: np.ndarray) -> np.ndarray:
    """``convert('L')`` of an RGB image: (19595 R + 38470 G + 7471 B +
    2¹⁵) >> 16."""
    i = img.astype(np.int64)
    return ((i[..., 0] * 19595 + i[..., 1] * 38470 + i[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


_SMOOTH = np.array([1, 1, 1, 1, 5, 1, 1, 1, 1], np.float32) / np.float32(13)


def smooth(img: np.ndarray) -> np.ndarray:
    """``filter(ImageFilter.SMOOTH)``: the 3×3 kernel [[1,1,1],[1,5,1],[1,1,1]]
    / 13 in float32, rows summed bottom first as PIL's C loop does,
    rounded; the one-pixel border keeps its values."""
    H, W = img.shape[:2]
    out = img.copy()
    if H < 3 or W < 3:
        return out
    f = img.astype(np.float32)
    acc = np.zeros((H - 2, W - 2) + img.shape[2:], np.float32)
    for dy in (2, 1, 0):
        row = np.zeros_like(acc)
        for dx in range(3):
            row = row + f[dy:dy + H - 2, dx:dx + W - 2] * _SMOOTH[dy * 3 + dx]
        acc = acc + row
    out[1:-1, 1:-1] = np.clip(np.floor(acc + np.float32(0.5)), 0, 255).astype(np.uint8)
    return out


def _fill(img, fill):
    return np.broadcast_to(np.asarray(fill, np.uint8), img.shape[2:])


def warp_bilinear(img: np.ndarray, a, fill) -> np.ndarray:
    """PIL's AFFINE transform, BILINEAR: output pixel (x, y) samples
    (a0·(x+½) + a1·(y+½) + a2, a3·(x+½) + a4·(y+½) + a5) when it lies in
    the image, else ``fill``; taps clamped at the edges, truncated."""
    H, W = img.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    xin = a[0] * (xs + 0.5) + a[1] * (ys + 0.5) + a[2]
    yin = a[3] * (xs + 0.5) + a[4] * (ys + 0.5) + a[5]
    inside = (xin >= 0) & (xin < W) & (yin >= 0) & (yin < H)
    xi, yi = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xi).astype(np.int64), np.floor(yi).astype(np.int64)
    dx, dy = xi - x0, yi - y0
    if img.ndim == 3:
        dx, dy = dx[..., None], dy[..., None]
    cx0, cx1 = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    cy0, cy1 = np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1)
    f = img.astype(np.float64)

    def row(cy):
        left = f[cy, cx0]
        return left + (f[cy, cx1] - left) * dx

    v1, v2 = row(cy0), row(cy1)
    out = (v1 + (v2 - v1) * dy).astype(np.uint8)
    mask = inside if img.ndim == 2 else inside[..., None]
    return np.where(mask, out, _fill(img, fill))


def _coord(v):
    return np.where(v < 0.0, -1, np.trunc(v)).astype(np.int64)


def _fix(v: float) -> int:
    v = v * 65536.0 + 0.5
    return math.floor(v) if v < 0 else int(v)


def warp_nearest(img: np.ndarray, a, fill) -> np.ndarray:
    """PIL's AFFINE transform, NEAREST: a scaling (a1 = a3 = 0) steps the
    source position by a0 and a4 from a2 + a0/2 and a5 + a4/2 in doubles;
    otherwise, while every corner maps inside ±32768, 16.16 fixed point
    stepping from FIX(a2 + a1/2 + a0/2) and FIX(a5 + a4/2 + a3/2), else
    the same stepping in doubles."""
    H, W = img.shape[:2]
    if a[1] == 0 and a[3] == 0:
        xs = np.add.accumulate(np.r_[a[2] + a[0] * 0.5, np.full(W - 1, a[0])])
        ys = np.add.accumulate(np.r_[a[5] + a[4] * 0.5, np.full(H - 1, a[4])])
        xi, yi = np.broadcast_arrays(_coord(xs)[None, :], _coord(ys)[:, None])
    elif all(abs(x * a[0] + y * a[1] + a[2]) < 32768.0 and abs(x * a[3] + y * a[4] + a[5]) < 32768.0
             for x, y in ((0, 0), (W, H), (0, H), (W, 0))):
        ys, xs = np.mgrid[0:H, 0:W].astype(np.int64)
        xi = (_fix(a[2] + a[1] * 0.5 + a[0] * 0.5) + ys * _fix(a[1]) + xs * _fix(a[0])) >> 16
        yi = (_fix(a[5] + a[4] * 0.5 + a[3] * 0.5) + ys * _fix(a[4]) + xs * _fix(a[3])) >> 16
    else:
        xrow = np.add.accumulate(np.r_[a[2] + a[1] * 0.5 + a[0] * 0.5, np.full(H - 1, a[1])])
        yrow = np.add.accumulate(np.r_[a[5] + a[4] * 0.5 + a[3] * 0.5, np.full(H - 1, a[4])])
        xi = _coord(np.add.accumulate(np.concatenate(
            [xrow[:, None], np.full((H, W - 1), a[0])], 1), axis=1))
        yi = _coord(np.add.accumulate(np.concatenate(
            [yrow[:, None], np.full((H, W - 1), a[3])], 1), axis=1))
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    return np.where(ok if img.ndim == 2 else ok[..., None], out, _fill(img, fill))


def rotation_affine(angle: float, w: int, h: int):
    """``Image.rotate``'s inverse matrix about the centre (w/2, h/2)."""
    ang = -math.radians(angle)
    m = [round(math.cos(ang), 15), round(math.sin(ang), 15), 0.0,
         round(-math.sin(ang), 15), round(math.cos(ang), 15), 0.0]
    cx, cy = w / 2, h / 2
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return m


def warp(img: np.ndarray, a, fill, bilinear: bool) -> np.ndarray:
    return (warp_bilinear if bilinear else warp_nearest)(img, a, fill)


def rotate(img: np.ndarray, angle: float, fill, bilinear: bool) -> np.ndarray:
    """``Image.rotate(angle, resample, fillcolor=fill)`` without expand for
    RandAugment's angles (|angle| ≤ 30): a copy at 0, else the warp (PIL's
    transposes at 90°, 180° and 270° are never reached)."""
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    return warp(img, rotation_affine(angle, img.shape[1], img.shape[0]), fill, bilinear)


def _contrast_degenerate(img):
    h = np.bincount(to_luma(img).reshape(-1), minlength=256)
    mean = int(float((np.arange(256) * h).sum()) / h.sum() + 0.5)
    return np.full_like(img, mean)


def _affine_op(data_fn):
    def op(x, v, fill, bilinear):
        return warp(x, data_fn(x, v), fill, bilinear)
    return op


# op → fn(img, v, fill, bilinear) on uint8 HWC (RGB) or HW arrays
PIL_OPS = {
    "auto_contrast": lambda x, v, f, b: autocontrast(x),
    "equalize": lambda x, v, f, b: equalize(x),
    "invert": lambda x, v, f, b: 255 - x,
    "rotate": lambda x, v, f, b: rotate(x, v, f, b),
    "posterize": lambda x, v, f, b: posterize(x, max(1, int(v))),
    "posterize_inc": lambda x, v, f, b: posterize(x, max(1, 4 - int(v))),
    "solarize": lambda x, v, f, b: point(x, lambda i: i if i < int(v) else 255 - i),
    "solarize_inc": lambda x, v, f, b: point(x, lambda i: i if i < 256 - v else 255 - i),
    "solarize_add": lambda x, v, f, b: point(
        x, lambda i: min(255, int(v) + i) if i < 128 else i),
    "color_inc": lambda x, v, f, b: blend(
        np.repeat(to_luma(x)[..., None], 3, 2), x, 1 + v),
    "contrast_inc": lambda x, v, f, b: blend(_contrast_degenerate(x), x, 1 + v),
    "brightness_inc": lambda x, v, f, b: blend(np.zeros_like(x), x, 1 + v),
    "sharpness_inc": lambda x, v, f, b: blend(smooth(x), x, 1 + v),
    "shear_x": _affine_op(lambda x, v: (1, v, 0, 0, 1, 0)),
    "shear_y": _affine_op(lambda x, v: (1, 0, 0, v, 1, 0)),
    "trans_x": _affine_op(lambda x, v: (1, 0, v * x.shape[1], 0, 1, 0)),
    "trans_y": _affine_op(lambda x, v: (1, 0, 0, 0, 1, v * x.shape[0])),
}

_AFFINE_OPS = ("rotate", "shear_x", "shear_y", "trans_x", "trans_y")

_OP_RANGES = {
    "auto_contrast": (0, 1, False), "equalize": (0, 1, False),
    "invert": (0, 1, False), "rotate": (0.0, 30.0, True),
    "posterize": (0, 4, False), "posterize_inc": (0, 4, False),
    "solarize": (0, 256, False), "solarize_inc": (0, 256, False),
    "solarize_add": (0, 110, False),
    "color_inc": (0, 0.9, True), "contrast_inc": (0, 0.9, True),
    "brightness_inc": (0, 0.9, True), "sharpness_inc": (0, 0.9, True),
    "shear_x": (0.0, 0.3, True), "shear_y": (0.0, 0.3, True),
    "trans_x": (0.0, 0.45, True), "trans_y": (0.0, 0.45, True),
}

RANDAUG_OPS = [
    "auto_contrast", "equalize", "rotate", "posterize_inc", "solarize_inc",
    "solarize_add", "color_inc", "contrast_inc", "brightness_inc",
    "sharpness_inc", "shear_x", "shear_y", "trans_x", "trans_y",
]

RANDAUG_OPS_REDUCED = [
    "auto_contrast", "equalize", "rotate", "color_inc", "contrast_inc",
    "brightness_inc", "sharpness_inc",
]


class RandAugment:
    """RandAugment (arXiv:1909.13719) for image + mask pairs: ``n_ops``
    operations drawn by ``random.sample`` from ``ops`` ("reduced", "full"
    or a list), each kept with probability ``p`` and applied at
    ``magnitude`` of its range, negated at random where the range is
    signed; the warps move the mask too (nearest, filled with
    ``ignore_value``).  Draws from ``random`` in the JAX transform's order.
    Returns ``{'image', 'target'}`` as uint8 arrays, as the JAX transform
    does."""

    def __init__(self, p=1.0, n_ops=2, magnitude=0.5, ops="reduced",
                 fill=(0, 0, 0), ignore_value=255):
        assert 0 <= magnitude <= 1
        self.p = p
        self.n_ops = int(n_ops)
        self.magnitude = magnitude
        self.fill = tuple(fill) if isinstance(fill, (list, tuple)) else (fill,) * 3
        self.ignore_value = ignore_value
        if ops == "full":
            self.ops = RANDAUG_OPS
        elif ops in ("reduced", None):
            self.ops = RANDAUG_OPS_REDUCED
        else:
            self.ops = list(ops)

    def __call__(self, sample):
        img, target = sample["image"], sample["target"]
        for op in random.sample(self.ops, self.n_ops):
            if self.p < 1 and random.random() > self.p:
                continue
            img, target = img.astype(np.uint8), target.astype(np.uint8)
            min_v, max_v, negate = _OP_RANGES[op]
            v = self.magnitude * (max_v - min_v) + min_v
            v = -v if negate and random.random() > 0.5 else v
            img = PIL_OPS[op](img, v, self.fill, True)
            if op in _AFFINE_OPS:
                target = PIL_OPS[op](target, v, self.ignore_value, False)
        return {"image": img, "target": target}


class _Transforms(dict):
    def __missing__(self, name):
        raise KeyError(f"no segmentation transform {name!r} in the port")


SEG_TRANSFORMS = _Transforms({
    "Resize": Resize,
    "RandAugment": RandAugment,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "RandomScaleCrop": RandomScaleCrop,
    "RandomScaleResize": RandomScaleResize,
    "RandomCrop": RandomCrop,
    "Pad": Pad,
    "RandomRotate": RandomRotate,
    "PhotoMetricDistortion": PhotoMetricDistortion,
    "ColorJitter": ColorJitter,
    "RGB2BGR": RGB2BGR,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
})

