"""Detection serving transforms (counterpart of
``cvpytorch_tpu/data/transforms/det_transforms.py``): letterbox ``Resize``,
``ToTensor`` and ``Normalize``.  Samples are ``{'image': HWC uint8 BGR,
'target': {'boxes': (N,4) xyxy pixels float32, 'labels': (N,)} or None}``.

The JAX package resizes with OpenCV; the port needs no OpenCV: it resizes
with ``torch.nn.functional.interpolate`` (bilinear, align_corners=False,
on the CPU) and pads with numpy.  The two agree within ±1 uint8 level.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """HWC uint8 → (oh, ow, C) uint8, bilinear with half-pixel centres."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x.float(), size=(oh, ow), mode="bilinear",
                      align_corners=False)
    y = y.round().clamp(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


class Resize:
    """Letterbox resize; records ``pads`` (left, top) and ``scales``
    (sw, sh) in the target for un-letterboxing."""

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
                img = _resize_bilinear(img, oh, ow)
            top, bottom = int(round(padh - 0.1)), int(round(padh + 0.1))
            left, right = int(round(padw - 0.1)), int(round(padw + 0.1))
            canvas = np.empty((oh + top + bottom, ow + left + right,
                               img.shape[2]), img.dtype)
            canvas[...] = np.asarray(self.fill, img.dtype)
            canvas[top:top + oh, left:left + ow] = img
            img = canvas
            if target is not None:
                boxes = target["boxes"]
                if len(boxes):
                    boxes = boxes * scale + np.array([left, top, left, top],
                                                    np.float32)
                target["boxes"] = boxes
                target["pads"] = np.array([left, top], np.float32)
                target["scales"] = np.array([scale, scale], np.float32)
        else:
            sh, sw = self.size[0] / h, self.size[1] / w
            img = _resize_bilinear(img, self.size[0], self.size[1])
            if target is not None:
                boxes = target["boxes"]
                if len(boxes):
                    boxes = boxes * np.array([sw, sh, sw, sh], np.float32)
                target["boxes"] = boxes
                target["pads"] = np.array([0.0, 0.0], np.float32)
                target["scales"] = np.array([sw, sh], np.float32)
        sample["image"] = img
        sample["target"] = target
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


DET_TRANSFORMS = {
    "Resize": Resize,
    "ToTensor": ToTensor,
    "Normalize": Normalize,
}
