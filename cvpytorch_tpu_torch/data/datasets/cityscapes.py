"""Cityscapes semantic segmentation (counterpart of
``cvpytorch_tpu/data/datasets/cityscapes.py``), read through the port's
``image_io.imread`` where the JAX package calls ``cv2.imread``.

Layout: ``IMG_DIR/<split>/<city>/*_leftImg8bit.png`` with labels under
``LABELS.SEG_DIR`` (suffix ``LABELS.SEG_SUFFIX``, default
``_gtFine_labelIds.png``); or an ``INDICES`` file of ``img_rel_path
label_rel_path`` lines.  Label ids map to the 19 train ids (others to the
ignore label 255) through a lookup table."""
from __future__ import annotations

import glob as globlib
import os

import numpy as np

from ...registry import DATASETS
from ..image_io import imread
from .base import Dataset

# labelId → trainId (cityscapesscripts convention)
_VALID = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
          22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
          32: 17, 33: 18}
_LUT = np.full(256, 255, dtype=np.uint8)
_LUT[list(_VALID)] = list(_VALID.values())


def encode_labelid_to_trainid(mask: np.ndarray) -> np.ndarray:
    return _LUT[mask]


@DATASETS.register(name="CityscapesSegmentation")
class CityscapesSegmentation(Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self._imgs: list[str] = []
        self._masks: list[str] = []
        img_dir = data_cfg.IMG_DIR
        seg_dir = (data_cfg.LABELS.SEG_DIR if data_cfg.LABELS else None) or img_dir
        if data_cfg.INDICES:
            with open(data_cfg.INDICES) as fd:
                for line in fd:
                    parts = line.strip().split(" ")
                    if not parts[0]:
                        continue
                    self._imgs.append(os.path.join(img_dir, parts[0]))
                    if len(parts) > 1:
                        self._masks.append(os.path.join(seg_dir, parts[1]))
        else:
            suffix = data_cfg.IMG_SUFFIX or "*_leftImg8bit.png"
            seg_suffix = (data_cfg.LABELS.SEG_SUFFIX
                          if data_cfg.LABELS else None) or "_gtFine_labelIds.png"
            for path in sorted(globlib.glob(
                    os.path.join(img_dir, "**", suffix), recursive=True)):
                self._imgs.append(path)
                rel = os.path.relpath(path, img_dir)
                self._masks.append(os.path.join(
                    seg_dir, rel.replace("_leftImg8bit.png", seg_suffix)))
        if not self._imgs:
            raise RuntimeError(f"Found 0 images under {img_dir}")

    def __len__(self):
        return len(self._imgs)

    def __getitem__(self, idx):
        img = imread(self._imgs[idx])
        if self.stage == "infer" or not self._masks:
            sample = {"image": img, "target": None, "id": self._imgs[idx]}
        else:
            mask = imread(self._masks[idx], grayscale=True)
            sample = {"image": img, "target": encode_labelid_to_trainid(mask)}
        return self.transform(sample) if self.transform else sample
