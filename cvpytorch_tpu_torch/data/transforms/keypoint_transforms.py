"""Keypoint transforms (counterpart of
``cvpytorch_tpu/data/transforms/keypoint_transforms.py``), on ``imgproc``
(no OpenCV).  Samples: ``{'image': HWC uint8 BGR, 'target': {'boxes':
(N, 4) xyxy pixels, 'labels': (N,), 'keypoints': (N, K, 3) [x, y, v]}}``;
the ``random`` calls are the JAX transforms', in their order.

Geometry moves boxes and keypoints together; a keypoint cropped off the
frame loses its visibility.  ``RandomHorizontalFlip`` swaps the COCO
chiral pairs by default (``flip_pairs="coco"``; ``None`` keeps them).
``Resize`` letterboxes with ``imgproc.resize_linear`` (``cv2.resize``)
and records ``pads``/``scales``: in the target, or (the infer stage,
where a sample has none) as keys of the sample, as the detection
``Resize`` does; the JAX transforms take a target only.
``CropWithFactor`` scales by ``cv2.resize(img, None, fx=s, fy=s)``'s
rule (source positions step by 1/s).
"""
from __future__ import annotations

import math
import random

import numpy as np

from .det_transforms import Normalize, ToTensor
from .imgproc import resize_linear


def _kps(target):
    k = target.get("keypoints") if target is not None else None
    return k if k is not None and k.shape[0] else None


def _boxes(target):
    b = target.get("boxes") if target is not None else None
    return b if b is not None and len(b) else None


def _zero_outside(keypoints, w, h):
    """Zero the visibility of keypoints outside [0, w) × [0, h)."""
    x, y = keypoints[..., 0], keypoints[..., 1]
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    keypoints[..., 2] = np.where(inside, keypoints[..., 2], 0.0)
    return keypoints


class RandomHorizontalFlip:
    """Mirror image, boxes and keypoints; ``flip_pairs`` swaps chiral
    joints."""

    COCO_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                  (13, 14), (15, 16))

    def __init__(self, p=0.5, flip_pairs="coco"):
        self.p = p
        self.flip_pairs = self.COCO_PAIRS if flip_pairs == "coco" else flip_pairs

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"]
        t = sample.get("target")
        w = img.shape[1]
        b = _boxes(t)
        if b is not None:
            b[:, [0, 2]] = w - 1 - b[:, [2, 0]]
        k = _kps(t)
        if k is not None:
            k[..., 0] = w - 1.0 - k[..., 0]
            for a, b_ in self.flip_pairs or ():
                k[:, [a, b_]] = k[:, [b_, a]]
            t["keypoints"] = k
        sample["image"] = np.ascontiguousarray(img[:, ::-1])
        return sample


class RandomVerticalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"]
        t = sample.get("target")
        h = img.shape[0]
        b = _boxes(t)
        if b is not None:
            b[:, [1, 3]] = h - 1 - b[:, [3, 1]]
        k = _kps(t)
        if k is not None:
            k[..., 1] = h - 1.0 - k[..., 1]
        sample["image"] = np.ascontiguousarray(img[::-1])
        return sample


class Resize:
    """Letterbox resize carrying boxes and keypoints."""

    def __init__(self, size, keep_ratio=True, scaleup=True, fill=(128, 128, 128)):
        self.size = list(size) if isinstance(size, (list, tuple)) else [size, size]
        self.keep_ratio = keep_ratio
        self.scaleup = scaleup
        self.fill = tuple(fill)

    def __call__(self, sample):
        img = sample["image"]
        t = sample.get("target")
        h, w = img.shape[:2]
        if self.keep_ratio:
            scale = min(self.size[0] / h, self.size[1] / w)
            if not self.scaleup:
                scale = min(scale, 1.0)
            oh, ow = int(round(h * scale)), int(round(w * scale))
            padh, padw = (self.size[0] - oh) / 2, (self.size[1] - ow) / 2
            if (h, w) != (oh, ow):
                img = resize_linear(img, (oh, ow))
            top, bottom = int(round(padh - 0.1)), int(round(padh + 0.1))
            left, right = int(round(padw - 0.1)), int(round(padw + 0.1))
            canvas = np.empty((oh + top + bottom, ow + left + right, img.shape[2]), img.dtype)
            canvas[...] = np.asarray(self.fill, img.dtype)
            canvas[top:top + oh, left:left + ow] = img
            img = canvas
            sx = sy = scale
            ox, oy = left, top
        else:
            sy, sx = self.size[0] / h, self.size[1] / w
            img = resize_linear(img, (self.size[0], self.size[1]))
            ox = oy = 0
        b = _boxes(t)
        if b is not None:
            b[:, 0::2] = b[:, 0::2] * sx + ox
            b[:, 1::2] = b[:, 1::2] * sy + oy
        k = _kps(t)
        if k is not None:
            k[..., 0] = k[..., 0] * sx + ox
            k[..., 1] = k[..., 1] * sy + oy
        pads = np.array([ox, oy], np.float32)
        scales = np.array([sx, sy], np.float32)
        if t is not None:
            t["pads"], t["scales"] = pads, scales
        else:
            sample["pads"], sample["scales"] = pads, scales
        sample["image"] = img
        return sample


class RandomResizedCrop:
    """torchvision-style area/aspect crop, then ``Resize``; boxes clipped
    (those under ``min_size`` dropped with their labels, areas and
    keypoints), off-crop keypoints invisible."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), keep_ratio=True,
                 fill=(128, 128, 128), min_size=3):
        self.size = list(size) if isinstance(size, (list, tuple)) else [size, size]
        self.scale, self.ratio = scale, ratio
        self.resize = Resize(self.size, keep_ratio, True, fill)
        self.min_size = min_size

    def _params(self, h, w):
        area = h * w
        log_r = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            ta = area * random.uniform(*self.scale)
            ar = math.exp(random.uniform(*log_r))
            cw = int(round(math.sqrt(ta * ar)))
            ch = int(round(math.sqrt(ta / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                return random.randint(0, h - ch), random.randint(0, w - cw), ch, cw
        in_ratio = w / h
        if in_ratio < min(self.ratio):
            cw, ch = w, int(round(w / min(self.ratio)))
        elif in_ratio > max(self.ratio):
            ch, cw = h, int(round(h * max(self.ratio)))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def __call__(self, sample):
        img = sample["image"]
        t = sample.get("target")
        h, w = img.shape[:2]
        i, j, ch, cw = self._params(h, w)
        sample["image"] = img[i:i + ch, j:j + cw]
        if _boxes(t) is not None:
            b = t["boxes"].copy()
            b[:, [0, 2]] = (b[:, [0, 2]] - j).clip(0, cw)
            b[:, [1, 3]] = (b[:, [1, 3]] - i).clip(0, ch)
            keep = ((b[:, 2] - b[:, 0]) >= self.min_size) & \
                   ((b[:, 3] - b[:, 1]) >= self.min_size)
            t["boxes"] = b[keep]
            t["labels"] = t["labels"][keep]
            if t.get("areas") is not None and len(t["areas"]):
                t["areas"] = t["areas"][keep]
            if _kps(t) is not None:
                k = t["keypoints"][keep].copy()
                k[..., 0] -= j
                k[..., 1] -= i
                t["keypoints"] = _zero_outside(k, cw, ch)
        return self.resize(sample)


class CropWithFactor:
    """Scale the short side to ``size``, then zero-pad H and W up to
    multiples of ``factor`` (the OpenPose eval convention)."""

    def __init__(self, size=None, factor=32, is_ceil=True):
        self.size, self.factor, self.is_ceil = size, factor, is_ceil

    def _closest(self, n):
        f = math.ceil if self.is_ceil else math.floor
        return int(f(n / self.factor)) * self.factor

    def __call__(self, sample):
        img = sample["image"]
        t = sample.get("target")
        h, w = img.shape[:2]
        s = float(self.size) / min(h, w)
        img = resize_linear(img, None, fxy=s)
        h2, w2 = img.shape[:2]
        out = np.zeros((self._closest(h2), self._closest(w2), img.shape[2]), img.dtype)
        out[:h2, :w2] = img
        if _boxes(t) is not None:
            t["boxes"] = t["boxes"] * s
        k = _kps(t)
        if k is not None:
            k[..., :2] *= s
        pads = np.array([0.0, 0.0], np.float32)
        scales = np.array([s, s], np.float32)
        if t is not None:
            t["pads"], t["scales"] = pads, scales
        else:
            sample["pads"], sample["scales"] = pads, scales
        sample["image"] = out
        return sample


KEYPOINT_TRANSFORMS = {
    "Resize": Resize,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "RandomVerticalFlip": RandomVerticalFlip,
    "RandomResizedCrop": RandomResizedCrop,
    "CropWithFactor": CropWithFactor,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
}
