"""Classification transforms (counterpart of
``cvpytorch_tpu/data/transforms/cls_transforms.py``) over samples
``{'image': HWC uint8 BGR, 'target': int or None}``, registered as the
``cls`` namespace.  The JAX transforms resize and convert colours with
OpenCV; these compute the same on ``imgproc`` (OpenCV's uint8
INTER_LINEAR and BGR↔HSV arithmetic) and draw from Python's ``random``
in the same order, so that one seed gives the JAX transform's output.
``RGB2BGR``, ``ToTensor`` (the label becomes int32) and ``Normalize`` are
the segmentation namespace's."""
from __future__ import annotations

import random

import numpy as np

from .imgproc import bgr_to_hsv, hsv_to_bgr, resize_linear, rotation_matrix_2d, warp_affine
from .seg_transforms import RGB2BGR, Normalize, ToTensor


class Resize:
    """To ``size`` (h, w), or with ``keep_ratio`` by the smaller scale,
    placed top-left on a zero canvas of ``size``."""

    def __init__(self, size, keep_ratio: bool = False):
        self.size = tuple(size)
        self.keep_ratio = keep_ratio

    def __call__(self, sample):
        img = sample["image"]
        h, w = self.size
        if self.keep_ratio:
            ih, iw = img.shape[:2]
            scale = min(h / ih, w / iw)
            nh, nw = int(round(ih * scale)), int(round(iw * scale))
            out = np.zeros((h, w, img.shape[2]), dtype=img.dtype)
            out[:nh, :nw] = resize_linear(img, (nh, nw))
            sample["image"] = out
        else:
            sample["image"] = resize_linear(img, (h, w))
        return sample


class RandomResizedCrop:
    """A random window of ``scale`` of the area and ``ratio`` of aspect
    (10 tries), resized to ``size``; else the centre crop of the image
    resized to the larger side of ``size``.  ``keep_ratio`` is accepted
    for the configs and unused, as in the JAX transform."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 keep_ratio: bool = False):
        self.size = tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, sample):
        img = sample["image"]
        ih, iw = img.shape[:2]
        area = ih * iw
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            aspect = np.exp(random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= iw and 0 < h <= ih:
                x0 = random.randint(0, iw - w)
                y0 = random.randint(0, ih - h)
                sample["image"] = resize_linear(img[y0:y0 + h, x0:x0 + w], self.size)
                return sample
        side = max(self.size)
        return CenterCrop(self.size)(Resize((side, side))(sample))


class CenterCrop:
    """The centre ``size`` window; a smaller image is first resized up to
    at least ``size`` (INTER_LINEAR, ``cv2.resize``'s default)."""

    def __init__(self, size):
        self.size = tuple(size)

    def __call__(self, sample):
        img = sample["image"]
        ih, iw = img.shape[:2]
        h, w = self.size
        if ih < h or iw < w:
            img = resize_linear(img, (max(h, ih), max(w, iw)))
            ih, iw = img.shape[:2]
        y0, x0 = (ih - h) // 2, (iw - w) // 2
        sample["image"] = img[y0:y0 + h, x0:x0 + w]
        return sample


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            sample["image"] = np.ascontiguousarray(sample["image"][:, ::-1])
        return sample


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            sample["image"] = np.ascontiguousarray(sample["image"][::-1])
        return sample


class RandomRotation:
    """With probability ``p``, a rotation by an angle drawn from
    ``degrees`` (a pair, or ±degrees) about the image centre, bilinear,
    with a black border."""

    def __init__(self, degrees=10, p: float = 0.5):
        self.degrees = degrees if isinstance(degrees, (list, tuple)) else (-degrees, degrees)
        self.p = p

    def __call__(self, sample):
        if random.random() < self.p:
            img = sample["image"]
            h, w = img.shape[:2]
            angle = random.uniform(*self.degrees)
            m = rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
            sample["image"] = warp_affine(img, m, (w, h))
        return sample


class ColorJitter:
    """With probability ``p``: brightness (± ``brightness``·255), contrast
    (a factor from ``contrast``) on the float image, clipped to uint8, then
    saturation (a factor) and hue (± ``hue``·180) in HSV."""

    def __init__(self, p=0.5, brightness=0.125, contrast=(0.5, 1.5),
                 saturation=(0.5, 1.5), hue=0.07):
        self.p = p
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        img = sample["image"].astype(np.float32)
        if self.brightness:
            img += random.uniform(-self.brightness, self.brightness) * 255.0
        if self.contrast:
            img *= random.uniform(*self.contrast)
        img = np.clip(img, 0, 255).astype(np.uint8)
        if self.saturation or self.hue:
            hsv = bgr_to_hsv(img).astype(np.float32)
            if self.saturation:
                hsv[..., 1] *= random.uniform(*self.saturation)
            if self.hue:
                hsv[..., 0] += random.uniform(-self.hue, self.hue) * 180.0
                hsv[..., 0] %= 180.0
            hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
            img = hsv_to_bgr(hsv.astype(np.uint8))
        sample["image"] = img
        return sample


class _Transforms(dict):
    def __missing__(self, name):
        raise KeyError(f"no classification transform {name!r} in the port")


CLS_TRANSFORMS = _Transforms({
    "Resize": Resize,
    "RandomResizedCrop": RandomResizedCrop,
    "CenterCrop": CenterCrop,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "RandomVerticalFlip": RandomVerticalFlip,
    "RandomRotation": RandomRotation,
    "ColorJitter": ColorJitter,
    "RGB2BGR": RGB2BGR,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
})
