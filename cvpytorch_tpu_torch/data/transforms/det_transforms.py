"""Detection transforms and collates (counterpart of
``cvpytorch_tpu/data/transforms/det_transforms.py``): every name of the
JAX ``DET_TRANSFORMS``, the padded ``make_det_collate`` and the
``make_device_aug_collate`` of the device augmentation.  Samples are
``{'image': HWC uint8 BGR, 'target': {'boxes': (N,4) xyxy pixels float32,
'labels': (N,)} or None}``; ``RandomAffineWithMosaic`` takes the
LOAD_NUM = 4 or 9 group a dataset yields and returns one sample.

The JAX transforms call OpenCV; these call ``imgproc``, which computes
OpenCV's uint8 resizes, warps, blurs and colour conversions in numpy, and
draw from Python's ``random`` and numpy's global RNG in the same order, so
that one seed gives the JAX transform's output (``CLAHE`` to ±1, see its
docstring).  ``ToCXCYWH``, ``ToXYXY``, ``ToPercentCoords``,
``FilterAndRemapCocoCategories``, ``ConvertCocoPolysToMask`` and
``CopyPaste`` are config-compatible no-ops, as in the JAX package: boxes
stay xyxy pixels and the model's loss converts them.
"""
from __future__ import annotations

import math
import random

import numpy as np

from .imgproc import (bgr_to_gray, bgr_to_hsv, bgr_to_lab, clahe, equalize_hist,
                      gaussian_blur, hsv_to_bgr, lab_to_bgr, median_blur, resize_area,
                      resize_linear, rotation_matrix_2d, warp_affine, warp_perspective)


class Resize:
    """Letterbox resize; records ``pads`` (left, top) and ``scales``
    (sw, sh) for un-letterboxing: in the target, or, in a sample without
    one (the infer stage), as keys of the sample, which the infer CLI
    hands to the model."""

    def __init__(self, size, keep_ratio=True, fill=(114, 114, 114)):
        self.size = list(size) if isinstance(size, (list, tuple)) else [size, size]
        self.keep_ratio = keep_ratio
        self.fill = tuple(fill)

    def __call__(self, sample):
        img = sample["image"]
        target = sample.get("target")
        h, w = img.shape[:2]
        if self.keep_ratio:
            scale = min(self.size[0] / h, self.size[1] / w)
            oh, ow = int(round(h * scale)), int(round(w * scale))
            padh, padw = (self.size[0] - oh) / 2, (self.size[1] - ow) / 2
            if (h, w) != (oh, ow):
                img = resize_linear(img, (oh, ow))
            top, bottom = int(round(padh - 0.1)), int(round(padh + 0.1))
            left, right = int(round(padw - 0.1)), int(round(padw + 0.1))
            canvas = np.empty((oh + top + bottom, ow + left + right,
                               img.shape[2]), img.dtype)
            canvas[...] = np.asarray(self.fill, img.dtype)
            canvas[top:top + oh, left:left + ow] = img
            img = canvas
            pads = np.array([left, top], np.float32)
            scales = np.array([scale, scale], np.float32)
            if target is not None:
                boxes = target["boxes"]
                if len(boxes):
                    boxes = boxes * scale + np.array([left, top, left, top],
                                                    np.float32)
                target["boxes"] = boxes
        else:
            sh, sw = self.size[0] / h, self.size[1] / w
            img = resize_linear(img, tuple(self.size))
            pads = np.array([0.0, 0.0], np.float32)
            scales = np.array([sw, sh], np.float32)
            if target is not None:
                boxes = target["boxes"]
                if len(boxes):
                    boxes = boxes * np.array([sw, sh, sw, sh], np.float32)
                target["boxes"] = boxes
        if target is not None:
            target["pads"], target["scales"] = pads, scales
        else:
            sample["pads"], sample["scales"] = pads, scales
        sample["image"] = img
        sample["target"] = target
        return sample


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            img = sample["image"]
            w = img.shape[1]
            sample["image"] = np.ascontiguousarray(img[:, ::-1])
            t = sample.get("target")
            if t is not None and len(t["boxes"]):
                boxes = t["boxes"].copy()
                boxes[:, [0, 2]] = w - t["boxes"][:, [2, 0]]
                t["boxes"] = boxes
                if t.get("masks") is not None:
                    # the masks span the whole image, so they flip with it
                    # (the JAX transform leaves them unflipped)
                    t["masks"] = np.ascontiguousarray(t["masks"][..., ::-1])
        return sample


class ColorHSV:
    """HSV gain jitter through lookup tables: after a ``random.random()``
    coin, the three gains are drawn from numpy's global RNG
    (``np.random.uniform``), as the JAX transform draws them."""

    def __init__(self, p=0.5, hue=0.015, saturation=0.7, value=0.4):
        self.p = p
        self.gains = (hue, saturation, value)

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"]
        r = np.random.uniform(-1, 1, 3) * self.gains + 1
        hsv = bgr_to_hsv(img)
        x = np.arange(256, dtype=r.dtype)
        luts = (((x * r[0]) % 180).astype(img.dtype),
                np.clip(x * r[1], 0, 255).astype(img.dtype),
                np.clip(x * r[2], 0, 255).astype(img.dtype))
        hsv = np.stack([lut[hsv[..., i]] for i, lut in enumerate(luts)], -1)
        sample["image"] = hsv_to_bgr(hsv)
        return sample


class ToTensor:
    """BGR→RGB float HWC /255."""

    def __call__(self, sample):
        img = sample["image"][..., ::-1]
        sample["image"] = np.ascontiguousarray(img, dtype=np.float32) / 255.0
        t = sample.get("target")
        if t is not None:
            t["boxes"] = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
            t["labels"] = np.asarray(t["labels"], np.int32).reshape(-1)
        return sample


class Normalize:
    def __init__(self, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample):
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


def _box_candidates(old, new, wh_thr=2, ar_thr=20, area_thr=0.1):
    """Boxes that keep a width and height above ``wh_thr`` pixels, an area
    above ``area_thr`` of the unwarped box's and an aspect below
    ``ar_thr`` after the warp."""
    w1, h1 = old[:, 2] - old[:, 0], old[:, 3] - old[:, 1]
    w2, h2 = new[:, 2] - new[:, 0], new[:, 3] - new[:, 1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return (w2 > wh_thr) & (h2 > wh_thr) & \
        (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr)


def _range(v, center=0.0):
    """A draw from ``[lo, hi]`` given as a pair, or from ``center ± v``;
    a zero range draws too."""
    if isinstance(v, (list, tuple)):
        return random.uniform(v[0], v[1])
    return random.uniform(center - v, center + v)


def random_perspective(img, boxes, labels, degrees=0.0, translate=0.1,
                       scale=0.5, shear=0.0, perspective=0.0, border=(0, 0),
                       fill=(114, 114, 114)):
    """Random perspective / affine warp of an image and its boxes.  Draws,
    in order: the two perspective terms, the angle, the scale, the two
    shears and the two translations.  The image is warped unless the map
    is the identity and there is no border; boxes are the bounds of their
    warped corners, clipped, and filtered by ``_box_candidates``."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = _range(perspective)
    P[2, 1] = _range(perspective)
    use_persp = (P[2, 0] != 0.0) or (P[2, 1] != 0.0)
    R = np.eye(3)
    a = _range(degrees)
    s = _range(scale, center=1.0)
    R[:2] = rotation_matrix_2d((0, 0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(_range(shear) * math.pi / 180)
    S[1, 0] = math.tan(_range(shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = _range(translate, center=0.5) * width
    T[1, 2] = _range(translate, center=0.5) * height
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if use_persp:
            img = warp_perspective(img, M, (width, height), fill)
        else:
            img = warp_affine(img, M[:2], (width, height), fill)
    n = len(boxes)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if use_persp else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = _box_candidates(boxes * s, new)
        boxes, labels = new[keep].astype(np.float32), labels[keep]
    return img, boxes, labels


class RandomAffine:
    """With probability ``p``, ``random_perspective`` of a sample with a
    target."""

    def __init__(self, p=1.0, degrees=0.0, translate=0.1, scale=0.5,
                 shear=0.0, perspective=0.0):
        self.p = p
        self.kw = dict(degrees=degrees, translate=translate, scale=scale,
                       shear=shear, perspective=perspective)

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        t = sample.get("target")
        if t is None:
            return sample
        img, boxes, labels = random_perspective(
            sample["image"], t["boxes"], t["labels"], **self.kw)
        sample["image"] = img
        t["boxes"], t["labels"] = boxes, labels
        return sample


def _mosaic_sample(img, boxes, labels):
    target = {"boxes": boxes.astype(np.float32),
              "labels": labels.astype(np.int64),
              "pads": np.array([0.0, 0.0], np.float32),
              "scales": np.array([1.0, 1.0], np.float32)}
    return {"image": img, "target": target}


class RandomAffineWithMosaic(RandomAffine):
    """Mosaic of a LOAD_NUM = 4 or 9 group, then ``random_perspective``
    with a border of half the tile, to a ``size`` sample; a single sample
    takes the plain affine.  As in the JAX transform, ``perspective`` is
    accepted and dropped (the warp is affine), ``p`` applies to single
    samples only, and the canvas is filled with ``fill[0]`` on every
    channel (the warp's border takes ``fill``)."""

    def __init__(self, p=1.0, degrees=0.0, translate=0.1, scale=0.5,
                 shear=0.0, perspective=0.0, fill=(114, 114, 114),
                 size=(640, 640)):
        super().__init__(p, degrees, translate, scale, shear)
        self.fill = tuple(fill)
        self.size = tuple(size) if isinstance(size, (list, tuple)) else (size, size)

    def __call__(self, samples):
        if isinstance(samples, dict):
            return super().__call__(samples)
        if len(samples) == 9:
            return self._mosaic9(samples)
        if len(samples) != 4:
            raise ValueError("mosaic takes a LOAD_NUM of 4 or 9 samples")
        sh, sw = self.size
        yc = int(random.uniform(sh // 2, 2 * sh - sh // 2))
        xc = int(random.uniform(sw // 2, 2 * sw - sw // 2))
        canvas = np.full((sh * 2, sw * 2, 3), self.fill[0], np.uint8)
        all_boxes, all_labels = [], []
        for i, s in enumerate(samples):
            img = s["image"]
            h, w = img.shape[:2]
            if i == 0:  # top-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
                x2b, y2b = w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, sw * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), x2a - x1a, h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(sh * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, y2a - y1a
            else:  # bottom-right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, sw * 2), min(sh * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, x2a - x1a, y2a - y1a
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            t = s.get("target")
            if t is not None and len(t["boxes"]):
                b = t["boxes"].copy()
                b[:, [0, 2]] += x1a - x1b
                b[:, [1, 3]] += y1a - y1b
                all_boxes.append(b)
                all_labels.append(t["labels"])
        boxes = np.concatenate(all_boxes, 0) if all_boxes else np.zeros((0, 4), np.float32)
        labels = np.concatenate(all_labels, 0) if all_labels else np.zeros((0,), np.int32)
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * sw)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * sh)
        img, boxes, labels = random_perspective(
            canvas, boxes, labels, border=(-sh // 2, -sw // 2),
            fill=self.fill, **self.kw)
        return _mosaic_sample(img, boxes, labels)

    def _mosaic9(self, samples):
        """Nine samples, each scaled to fit ``size`` (bilinear up, area
        down), placed in a spiral (centre, top, top-right, right,
        bottom-right, bottom, bottom-left, left, top-left) on a 3s × 3s
        canvas, which a random 2s × 2s window crops."""
        sh, sw = self.size
        canvas = None
        all_boxes, all_labels = [], []
        h0 = w0 = hp = wp = 0
        for i, s in enumerate(samples):
            img = s["image"]
            ih, iw = img.shape[:2]
            r = min(sh / ih, sw / iw)
            h, w = int(round(ih * r)), int(round(iw * r))
            if (ih, iw) != (h, w):
                img = resize_linear(img, (h, w)) if r > 1 else resize_area(img, (h, w))
            if i == 0:  # center
                canvas = np.full((sh * 3, sw * 3, 3), self.fill[0], np.uint8)
                h0, w0 = h, w
                c = sw, sh, sw + w, sh + h
            elif i == 1:  # top
                c = sw, sh - h, sw + w, sh
            elif i == 2:  # top right
                c = sw + wp, sh - h, sw + wp + w, sh
            elif i == 3:  # right
                c = sw + w0, sh, sw + w0 + w, sh + h
            elif i == 4:  # bottom right
                c = sw + w0, sh + hp, sw + w0 + w, sh + hp + h
            elif i == 5:  # bottom
                c = sw + w0 - w, sh + h0, sw + w0, sh + h0 + h
            elif i == 6:  # bottom left
                c = sw + w0 - wp - w, sh + h0, sw + w0 - wp, sh + h0 + h
            elif i == 7:  # left
                c = sw - w, sh + h0 - h, sw, sh + h0
            else:  # top left
                c = sw - w, sh + h0 - hp - h, sw, sh + h0 - hp
            padw, padh = c[0], c[1]
            x1, y1, x2, y2 = (max(v, 0) for v in c)
            canvas[y1:y2, x1:x2] = img[y1 - padh:y1 - padh + (y2 - y1),
                                       x1 - padw:x1 - padw + (x2 - x1)]
            t = s.get("target")
            if t is not None and len(t["boxes"]):
                b = t["boxes"].astype(np.float64) * r
                b[:, [0, 2]] += padw
                b[:, [1, 3]] += padh
                all_boxes.append(b)
                all_labels.append(t["labels"])
            hp, wp = h, w
        yc = int(random.uniform(0, sh))
        xc = int(random.uniform(0, sw))
        canvas = canvas[yc:yc + 2 * sh, xc:xc + 2 * sw]
        boxes = (np.concatenate(all_boxes, 0) if all_boxes
                 else np.zeros((0, 4), np.float64))
        labels = (np.concatenate(all_labels, 0) if all_labels
                  else np.zeros((0,), np.int64))
        if len(boxes):
            boxes[:, [0, 2]] = (boxes[:, [0, 2]] - xc).clip(0, 2 * sw)
            boxes[:, [1, 3]] = (boxes[:, [1, 3]] - yc).clip(0, 2 * sh)
        img, boxes, labels = random_perspective(
            canvas, boxes.astype(np.float32), labels,
            border=(-sh // 2, -sw // 2), fill=self.fill, **self.kw)
        return _mosaic_sample(img, boxes, labels)


class _NoOp:
    """A config-compatible no-op, as in the JAX package."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, sample):
        return sample


class FilterAndRemapCocoCategories(_NoOp):
    """The dataset filters and remaps the categories."""


class ConvertCocoPolysToMask(_NoOp):
    """The COCO dataset extracts the boxes."""


class ToCXCYWH(_NoOp):
    """The boxes stay xyxy pixels; the model's loss converts them."""


class ToXYXY(_NoOp):
    """The boxes stay xyxy pixels."""


class ToPercentCoords(_NoOp):
    """The boxes stay pixels; the model's loss normalises them."""


class CopyPaste(_NoOp):
    """A stub in the JAX package too."""


class GaussianBlur:
    """With probability ``p``, OpenCV's sigma-0 Gaussian of ``ksize | 1``."""

    def __init__(self, p=0.01, ksize=5):
        self.p, self.ksize = p, ksize

    def __call__(self, sample):
        if random.random() < self.p:
            sample["image"] = gaussian_blur(sample["image"], self.ksize | 1)
        return sample


class MedianBlur:
    """With probability ``p``, the ``ksize | 1`` median."""

    def __init__(self, p=0.01, ksize=5):
        self.p, self.ksize = p, ksize

    def __call__(self, sample):
        if random.random() < self.p:
            sample["image"] = median_blur(sample["image"], self.ksize | 1)
        return sample


class RandomGrayscale:
    """With probability ``p``, OpenCV's grey copied to three channels."""

    def __init__(self, p=0.01):
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            g = bgr_to_gray(sample["image"])
            sample["image"] = np.repeat(g[..., None], 3, axis=2)
        return sample


class RandomGamma:
    """With probability ``p``, a gamma of ``randint(*gamma_limit) / 100``
    through a lookup table on uint8 (a power on float images)."""

    def __init__(self, p=0.01, gamma_limit=(80, 120)):
        self.p, self.gamma_limit = p, gamma_limit

    def __call__(self, sample):
        if random.random() < self.p:
            img = sample["image"]
            gamma = random.randint(*[int(g) for g in self.gamma_limit]) / 100.0
            if img.dtype == np.uint8:
                table = (np.arange(0, 256.0 / 255, 1.0 / 255) ** gamma) * 255
                img = table.astype(np.uint8)[img]
            else:
                img = np.power(img, gamma)
            sample["image"] = img
        return sample


class EqualizeHist:
    """With probability ``p``, ``equalize_hist`` on each channel."""

    def __init__(self, p=0.01):
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            img = sample["image"]
            if img.ndim == 2:
                img = equalize_hist(img)
            else:
                img = np.stack([equalize_hist(np.ascontiguousarray(img[..., c]))
                                for c in range(img.shape[2])], -1)
            sample["image"] = img
        return sample


class CLAHE:
    """With probability ``p``, ``imgproc.clahe`` on the L of OpenCV's 8-bit
    Lab (or on a one-channel image) with a clip limit drawn from
    ``clip_limit``.  The Lab round trip differs from OpenCV's by 1 on a
    few per cent of values (``imgproc.lab_to_bgr``)."""

    def __init__(self, p=0.01, clip_limit=(1.0, 4.0), tile_grid_size=(8, 8)):
        self.p = p
        self.clip_limit = clip_limit if isinstance(clip_limit, (list, tuple)) \
            else (1.0, float(clip_limit))
        self.tile_grid_size = tuple(tile_grid_size)

    def __call__(self, sample):
        if random.random() < self.p:
            img = sample["image"]
            clip = random.uniform(*self.clip_limit)
            if img.ndim == 2 or img.shape[2] == 1:
                img = clahe(img.reshape(img.shape[:2]), clip, self.tile_grid_size)
            else:
                lab = bgr_to_lab(img)
                lab[:, :, 0] = clahe(np.ascontiguousarray(lab[:, :, 0]), clip,
                                     self.tile_grid_size)
                img = lab_to_bgr(lab)
            sample["image"] = img
        return sample


class RandomFog:
    """Radial fog ``img·e^{−t·d} + brightness·(1 − e^{−t·d})`` with ``d`` a
    centred distance field; brightness and thickness are drawn from
    numpy's global RNG."""

    def __init__(self, p=0.1, brightness=(0.1, 0.9), thickness=(0.01, 0.09)):
        self.p = p
        self.brightness = brightness
        self.thickness = thickness

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"]
        br = float(np.clip(0.2 * np.random.randn() + 0.5,
                           self.brightness[0], self.brightness[1]))
        th = float(np.clip(0.01 * np.random.randn() + 0.05,
                           self.thickness[0], self.thickness[1]))
        x = img.astype(np.float32) / 255.0
        h, w = x.shape[:2]
        size = math.sqrt(max(h, w))
        yy = np.arange(h, dtype=np.float32)[:, None] - h // 2
        xx = np.arange(w, dtype=np.float32)[None, :] - w // 2
        d = -0.04 * np.sqrt(yy * yy + xx * xx) + size
        td = np.exp(-th * d)[..., None]
        x = np.clip(x * td + br * (1.0 - td), 0.0, 1.0)
        sample["image"] = (x * 255).astype(np.uint8)
        return sample


class Cutout:
    """With probability ``p``, one grey-ish rectangle for each of
    ``scales`` (a fraction of the side), centred at random, in place."""

    def __init__(self, p=0.5, scales=(0.125, 0.0625, 0.03125), fill=True):
        self.p = p
        self.scales = scales

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"]
        h, w = img.shape[:2]
        for s in self.scales:
            mh, mw = int(h * s), int(w * s)
            y = random.randint(0, h - 1)
            x = random.randint(0, w - 1)
            img[max(y - mh // 2, 0):min(y + mh // 2, h),
                max(x - mw // 2, 0):min(x + mw // 2, w)] = \
                [random.randint(64, 191) for _ in range(3)]
        sample["image"] = img
        return sample


class MixUp:
    """Blend a sample with the one before it (a LOAD_NUM = 2 group, or the
    previous call's sample, which the transform keeps) with a weight
    drawn from numpy's Beta(alpha, alpha); the boxes are concatenated."""

    def __init__(self, p=0.15, alpha=32.0):
        self.p = p
        self.alpha = alpha
        self._prev = None

    def __call__(self, sample):
        if isinstance(sample, list):
            a, b = sample[0], sample[1]
        else:
            a, b = sample, self._prev
            self._prev = {"image": sample["image"].copy(),
                          "target": None if sample.get("target") is None else
                          {k: (v.copy() if hasattr(v, "copy") else v)
                           for k, v in sample["target"].items()}}
        if b is None or random.random() >= self.p:
            return a
        if a["image"].shape != b["image"].shape:
            return a
        lam = np.random.beta(self.alpha, self.alpha)
        img = (a["image"].astype(np.float32) * lam +
               b["image"].astype(np.float32) * (1 - lam))
        a["image"] = img.astype(a["image"].dtype)
        ta, tb = a.get("target"), b.get("target")
        if ta is not None and tb is not None:
            ta["boxes"] = np.concatenate([ta["boxes"], tb["boxes"]], 0)
            ta["labels"] = np.concatenate([ta["labels"], tb["labels"]], 0)
        return a


class _Transforms(dict):
    def __missing__(self, name):
        raise KeyError(f"no detection transform {name!r} in the port")


DET_TRANSFORMS = _Transforms({
    "Resize": Resize,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "ColorHSV": ColorHSV,
    "RandomAffine": RandomAffine,
    "RandomAffineWithMosaic": RandomAffineWithMosaic,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
    "FilterAndRemapCocoCategories": FilterAndRemapCocoCategories,
    "ConvertCocoPolysToMask": ConvertCocoPolysToMask,
    "GaussianBlur": GaussianBlur,
    "MedianBlur": MedianBlur,
    "RandomGrayscale": RandomGrayscale,
    "RandomGamma": RandomGamma,
    "EqualizeHist": EqualizeHist,
    "CLAHE": CLAHE,
    "RandomFog": RandomFog,
    "Cutout": Cutout,
    "MixUp": MixUp,
    "CopyPaste": CopyPaste,
    "ToCXCYWH": ToCXCYWH,
    "ToXYXY": ToXYXY,
    "ToPercentCoords": ToPercentCoords,
})


def make_device_aug_collate(max_boxes: int = 32, tile: int = 640,
                            fill=(114, 114, 114)):
    """Collate for the DEVICE_AUG path: each dataset item is a LOAD_NUM=4
    group of raw samples; the host letterboxes each to ``tile``² uint8 and
    stacks them to (B, 4, S, S, 3).  Mosaic, affine, HSV, flip and
    normalise run on the device (``ops.augment.fused_det_augment``)."""
    resize = Resize((tile, tile), keep_ratio=True, fill=fill)

    def collate(samples):
        B = len(samples)
        images = np.zeros((B, 4, tile, tile, 3), np.uint8)
        boxes = np.zeros((B, 4, max_boxes, 4), np.float32)
        labels = np.zeros((B, 4, max_boxes), np.int32)
        valid = np.zeros((B, 4, max_boxes), bool)
        for i, group in enumerate(samples):
            if not (isinstance(group, (list, tuple)) and len(group) == 4):
                raise ValueError("DEVICE_AUG needs LOAD_NUM: 4 and no host "
                                 "mosaic transform")
            for j, s in enumerate(group):
                s = resize({"image": s["image"], "target": s.get("target")})
                images[i, j] = s["image"]
                t = s.get("target")
                if t is None or not len(t["boxes"]):
                    continue
                n = min(len(t["boxes"]), max_boxes)
                boxes[i, j, :n] = t["boxes"][:n]
                labels[i, j, :n] = t["labels"][:n]
                valid[i, j, :n] = True
        return {"image": images,
                "target": {"boxes": boxes, "labels": labels, "valid": valid}}

    return collate


def make_det_collate(max_boxes: int = 64):
    """Padded fixed-shape detection batch: targets padded to ``max_boxes``
    with a validity mask, plus the letterbox ``pads``/``scales``, the image
    ``height``/``width``, ``image_id`` and, when the samples carry them,
    the instance ``masks`` (B, max_boxes, Hm, Wm), the ``keypoints``
    (B, max_boxes, K, 3) and the annotation ``areas`` (B, max_boxes)."""

    def det_collate(samples):
        images = np.stack([s["image"] for s in samples])
        B = len(samples)
        boxes = np.zeros((B, max_boxes, 4), np.float32)
        labels = np.zeros((B, max_boxes), np.int32)
        valid = np.zeros((B, max_boxes), bool)
        pads = np.zeros((B, 2), np.float32)
        scales = np.ones((B, 2), np.float32)
        heights = np.zeros((B,), np.int32)
        widths = np.zeros((B,), np.int32)
        img_ids = np.zeros((B,), np.int64)
        masks = kpts = areas = None
        for i, s in enumerate(samples):
            t = s.get("target")
            heights[i], widths[i] = s["image"].shape[:2]
            if t is None:
                continue
            n = min(len(t["boxes"]), max_boxes)
            if n:
                boxes[i, :n] = t["boxes"][:n]
                labels[i, :n] = t["labels"][:n]
                valid[i, :n] = True
                if t.get("masks") is not None and len(t["masks"]):
                    if masks is None:
                        mh = t["masks"].shape[-1]
                        masks = np.zeros((B, max_boxes, mh, mh), np.float32)
                    masks[i, :n] = t["masks"][:n]
                if t.get("keypoints") is not None and len(t["keypoints"]):
                    if kpts is None:
                        kpts = np.zeros((B, max_boxes, t["keypoints"].shape[1], 3), np.float32)
                    kpts[i, :n] = t["keypoints"][:n]
                if t.get("areas") is not None and len(t["areas"]):
                    # the OKS protocol normalises by annotation areas
                    if areas is None:
                        areas = np.zeros((B, max_boxes), np.float32)
                    areas[i, :n] = t["areas"][:n]
            pads[i] = t.get("pads", (0, 0))
            scales[i] = t.get("scales", (1, 1))
            if "height" in t:
                heights[i] = t["height"]
            if "width" in t:
                widths[i] = t["width"]
            img_ids[i] = t.get("image_id", i)
        target = {
            "boxes": boxes, "labels": labels, "valid": valid,
            "pads": pads, "scales": scales,
            "height": heights, "width": widths,
        }
        for key, value in (("masks", masks), ("keypoints", kpts), ("areas", areas)):
            if value is not None:
                target[key] = value
        return {"image": images, "target": target, "image_id": img_ids}

    return det_collate
