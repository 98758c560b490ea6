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
``imgproc.warp_affine``.  ``RandAugment`` (PIL's operations in the JAX
package) is used by no config and not ported; naming it raises a
``KeyError``.
"""
from __future__ import annotations

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


class _Transforms(dict):
    def __missing__(self, name):
        if name == "RandAugment":
            raise KeyError(
                "RandAugment (PIL's operations in the JAX package) is not ported "
                "yet (ROADMAP, Queue 1 item 10)")
        raise KeyError(f"no segmentation transform {name!r} in the port")


SEG_TRANSFORMS = _Transforms({
    "Resize": Resize,
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

