"""Synthetic classification, segmentation, detection and
instance-segmentation data (counterparts of ``SyntheticClassification``,
``SyntheticSegmentation``, ``SyntheticDetection`` and
``SyntheticInstanceSegmentation`` in
``cvpytorch_tpu/data/datasets/synthetic.py``): the same seeds give the same
images, masks and boxes as the JAX package.

A train-stage ``LOAD_NUM`` > 1 makes each item a group: the indexed sample
and ``LOAD_NUM - 1`` others drawn with Python's ``random`` (the mosaic
fan-in of the device augmentation)."""
from __future__ import annotations

import random

import numpy as np

from ...registry import DATASETS
from .base import Dataset


@DATASETS.register(name="SyntheticClassification")
class SyntheticClassification(Dataset):
    """Class-conditional noise: class t adds (40·t) mod 256 to uint8 noise
    in [0, 40) (wrapping) and paints every (t + 2)-th column white.  The JAX
    dataset adds ``np.uint8(40 * t)``, which wrapped under numpy 1 and
    raises under numpy 2 for t ≥ 7.  Infer-stage samples carry no
    target."""

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.length = int(getattr(data_cfg, "LENGTH", None) or 256)
        size = getattr(data_cfg, "SIZE", None) or [64, 64]
        self.size = tuple(size)
        self.n_cls = max(len(self.dictionary), 2)
        self._rng = np.random.RandomState(
            int(getattr(data_cfg, "SEED", None) or 0) + (1 if stage != "train" else 0)
        )
        self._targets = self._rng.randint(0, self.n_cls, size=self.length)
        self._seeds = self._rng.randint(0, 2**31 - 1, size=self.length)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seeds[idx])
        t = int(self._targets[idx])
        img = rng.randint(0, 40, (*self.size, 3)).astype(np.uint8)
        img = img + np.uint8((40 * t) % 256)
        img[:, :: (t + 2), :] = 255
        sample = {"image": img, "target": None if self.stage == "infer" else t}
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="SyntheticSegmentation")
class SyntheticSegmentation(Dataset):
    """Images with coloured rectangles; the target is the (H, W) uint8 map
    of the rectangles' class ids (0 elsewhere).  Class c paints the image
    with 50·c mod 256: the JAX dataset assigns 50·c to a uint8 array,
    which wrapped under numpy 1 and raises under numpy 2 for c ≥ 6.
    Infer-stage samples carry no target."""

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.length = int(getattr(data_cfg, "LENGTH", None) or 64)
        size = getattr(data_cfg, "SIZE", None) or [64, 64]
        self.size = tuple(size)
        self.n_cls = max(len(self.dictionary), 2)
        self._rng = np.random.RandomState(
            int(getattr(data_cfg, "SEED", None) or 0) + (1 if stage != "train" else 0)
        )
        self._seeds = self._rng.randint(0, 2**31 - 1, size=self.length)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seeds[idx])
        h, w = self.size
        img = rng.randint(0, 30, (h, w, 3)).astype(np.uint8)
        mask = np.zeros((h, w), dtype=np.uint8)
        for cls in range(1, self.n_cls):
            if rng.rand() < 0.8:
                x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
                bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
                img[y0:y0 + bh, x0:x0 + bw] = (50 * cls) % 256
                mask[y0:y0 + bh, x0:x0 + bw] = cls
        sample = {"image": img,
                  "target": None if self.stage == "infer" else mask}
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="SyntheticDetection")
class SyntheticDetection(Dataset):
    """Images with coloured boxes; targets are ``{'boxes', 'labels'}``.
    Infer-stage samples carry no target."""

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.length = int(getattr(data_cfg, "LENGTH", None) or 64)
        size = getattr(data_cfg, "SIZE", None) or [128, 128]
        self.size = tuple(size)
        self.n_cls = max(len(self.dictionary), 2)
        self.max_boxes = int(getattr(data_cfg, "MAX_BOXES", None) or 8)
        self._rng = np.random.RandomState(
            int(getattr(data_cfg, "SEED", None) or 0) + (1 if stage != "train" else 0)
        )
        self._seeds = self._rng.randint(0, 2**31 - 1, size=self.length)
        self.load_num = int(getattr(data_cfg, "LOAD_NUM", None) or 1) \
            if stage == "train" else 1

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if self.load_num > 1:
            group = [self._load_one(i) for i in
                     [idx] + [random.randrange(self.length)
                              for _ in range(self.load_num - 1)]]
            return self.transform(group) if self.transform else group
        sample = self._load_one(idx)
        return self.transform(sample) if self.transform else sample

    def _load_one(self, idx):
        rng = np.random.RandomState(self._seeds[idx])
        h, w = self.size
        img = rng.randint(0, 30, (h, w, 3)).astype(np.uint8)
        n = rng.randint(1, min(self.max_boxes, 5) + 1)
        boxes, labels = [], []
        for _ in range(n):
            cls = rng.randint(0, self.n_cls)
            bw = rng.randint(w // 8, w // 3)
            bh = rng.randint(h // 8, h // 3)
            x0 = rng.randint(0, w - bw)
            y0 = rng.randint(0, h - bh)
            img[y0:y0 + bh, x0:x0 + bw] = (60 + 80 * cls) % 255
            boxes.append([x0, y0, x0 + bw, y0 + bh])
            labels.append(cls)
        target = {
            "boxes": np.asarray(boxes, dtype=np.float32),
            "labels": np.asarray(labels, dtype=np.int32),
        }
        return {"image": img,
                "target": None if self.stage == "infer" else target}


@DATASETS.register(name="SyntheticInstanceSegmentation")
class SyntheticInstanceSegmentation(SyntheticDetection):
    """Detection boxes plus axis-aligned rectangular instance masks
    rasterised at ``MASK_SIZE`` over the full image canvas: the target
    contract of ``CocoSegmentation``."""

    MASK_SIZE = 64

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.mask_size = int(getattr(data_cfg, "MASK_SIZE", None) or self.MASK_SIZE)

    def _load_one(self, idx):
        sample = super()._load_one(idx)
        t = sample["target"]
        if t is not None:
            h, w = self.size
            s = self.mask_size
            masks = np.zeros((len(t["boxes"]), s, s), np.float32)
            for i, (x0, y0, x1, y1) in enumerate(t["boxes"]):
                masks[i, int(round(y0 * s / h)):int(round(y1 * s / h)),
                      int(round(x0 * s / w)):int(round(x1 * s / w))] = 1.0
            t["masks"] = masks
        return sample
