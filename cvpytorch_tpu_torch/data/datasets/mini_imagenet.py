"""Classification datasets on image files (counterparts of
``MiniImageNetClassification`` and ``FolderClassification`` in
``cvpytorch_tpu/data/datasets/mini_imagenet.py``), read through the
port's ``image_io.imread`` (JPEG and PNG as ``cv2.imread`` reads them; no
OpenCV on the card's machine).  (The JAX dataset's ``CACHE`` option, which
no config sets, is not ported.)

* ``MiniImageNetClassification`` — an ``INDICES`` file of ``relative/path
  <label_id>`` lines under ``IMG_DIR``; the infer stage reads the paths of
  ``INDICES``, or every image under ``IMG_DIR``, sorted.
* ``FolderClassification`` (alias ``ImagenetClassification``) —
  ``IMG_DIR/<class_name>/*``, the dictionary's names as labels; folders
  not in the dictionary are skipped.
"""
from __future__ import annotations

import os

from ...registry import DATASETS
from ..image_io import imread
from .base import Dataset

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


class _FileClassification(Dataset):
    _imgs: list
    _targets: list

    def __len__(self):
        return len(self._imgs)

    def __getitem__(self, idx: int) -> dict:
        sample = {"image": imread(self._imgs[idx]),
                  "target": None if self.stage == "infer" else self._targets[idx]}
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="MiniImageNetClassification")
class MiniImageNetClassification(_FileClassification):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self._imgs, self._targets = [], []
        img_dir = data_cfg.IMG_DIR
        if stage == "infer" and not data_cfg.INDICES:
            for root, _, files in sorted(os.walk(img_dir)):
                self._imgs += [os.path.join(root, f) for f in sorted(files)
                               if f.lower().endswith(IMAGE_SUFFIXES)]
        elif stage == "infer":
            with open(data_cfg.INDICES) as fd:
                self._imgs = [os.path.join(img_dir, line.strip()) for line in fd if line.strip()]
        else:
            if not data_cfg.INDICES:
                raise ValueError("an INDICES file is required for train and val")
            with open(data_cfg.INDICES) as fd:
                for line in fd:
                    if line.strip():
                        path, tgt = line.split()
                        self._imgs.append(os.path.join(img_dir, path))
                        self._targets.append(int(tgt))
        if not self._imgs:
            raise RuntimeError(f"Found 0 images under {img_dir}")


@DATASETS.register(name="FolderClassification", aliases=("ImagenetClassification",))
class FolderClassification(_FileClassification):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self._imgs, self._targets = [], []
        for cls_name in sorted(os.listdir(data_cfg.IMG_DIR)):
            cls_dir = os.path.join(data_cfg.IMG_DIR, cls_name)
            label = self.name2id.get(cls_name) if self.dictionary else None
            if not os.path.isdir(cls_dir) or label is None:
                continue
            for f in sorted(os.listdir(cls_dir)):
                if f.lower().endswith(IMAGE_SUFFIXES):
                    self._imgs.append(os.path.join(cls_dir, f))
                    self._targets.append(label)
        if not self._imgs:
            raise RuntimeError(f"Found 0 images under {data_cfg.IMG_DIR}")
