"""Detection transforms and collates (counterpart of
``cvpytorch_tpu/data/transforms/det_transforms.py``): letterbox ``Resize``,
``RandomHorizontalFlip``, ``ColorHSV``, ``ToTensor``, ``Normalize``, the
padded ``make_det_collate`` and the ``make_device_aug_collate`` of the
device augmentation.  Samples are ``{'image': HWC uint8 BGR, 'target':
{'boxes': (N,4) xyxy pixels float32, 'labels': (N,)} or None}``.

The JAX package resizes and converts colours with OpenCV; the port needs
no OpenCV: ``imgproc`` computes ``cv2.resize`` (INTER_LINEAR) and the
BGR↔HSV conversions to OpenCV's own uint8 arithmetic, so the letterbox
and ``ColorHSV`` equal the JAX transforms.  The other JAX transforms
built on OpenCV (``NEEDS_OPENCV``) are not ported yet; naming one raises
a ``KeyError``.  Train YOLOv5 with ``DEVICE_AUG`` instead: its mosaic,
affine, HSV and flip run on the device (``ops/augment.py``).
"""
from __future__ import annotations

import random

import numpy as np

from .imgproc import bgr_to_hsv, hsv_to_bgr, resize_linear


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


NEEDS_OPENCV = ("RandomAffine", "RandomAffineWithMosaic",
                "GaussianBlur", "MedianBlur", "RandomGrayscale", "RandomGamma",
                "EqualizeHist", "CLAHE")


class _Transforms(dict):
    def __missing__(self, name):
        if name in NEEDS_OPENCV:
            raise KeyError(
                f"{name} is built on OpenCV in the JAX package and is not "
                "ported yet (ROADMAP, Queue 1); train with DATASET.TRAIN."
                "DEVICE_AUG, which runs mosaic, affine, HSV and flip on the device")
        raise KeyError(f"no detection transform {name!r} in the port")


DET_TRANSFORMS = _Transforms({
    "Resize": Resize,
    "RandomHorizontalFlip": RandomHorizontalFlip,
    "ColorHSV": ColorHSV,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
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
    the instance ``masks`` (B, max_boxes, Hm, Wm).  (The JAX collate also
    pads keypoints and areas; they come with the keypoint family.)"""

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
        masks = None
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
        if masks is not None:
            target["masks"] = masks
        return {"image": images, "target": target, "image_id": img_ids}

    return det_collate
