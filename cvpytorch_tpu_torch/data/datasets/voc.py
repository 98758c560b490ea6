"""Pascal VOC datasets (counterparts of ``VOCDetection`` and
``VOCSegmentation`` in ``cvpytorch_tpu/data/datasets/voc.py``), registered
under the same names.  Layout of VOCdevkit: ``IMG_DIR/JPEGImages/`` (or
the images in ``IMG_DIR`` itself), ``Annotations/*.xml`` (or
``LABELS.DET_DIR``), ``SegmentationClass/*.png`` (or ``LABELS.SEG_DIR``);
an ``INDICES`` file lists the image ids, one per line (first word).

* ``VOCDetection``: the XML through ``xml.etree``; objects whose name is
  not in the dictionary skipped, ``difficult`` as ``int(text or 0)``, 1
  subtracted from ``xmin``/``ymin`` only; a ``.jpg`` image, else a
  ``.png`` one; without ``INDICES`` the sorted ``Annotations/*.xml``.
* ``VOCSegmentation``: ``JPEGImages/<id>.jpg`` and the class map
  ``<id>.png``, read by ``image_io.imread_label``: VOC's palette masks
  give their indices (255 stays the ignore border), where the JAX
  dataset's ``cv2.IMREAD_GRAYSCALE`` gives the palette colours' luma.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ...registry import DATASETS
from ..image_io import imread, imread_label
from .base import Dataset


def _read_ids(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip().split()[0] for line in f if line.strip()]


def _image_dir(root: str) -> str:
    jpeg_dir = os.path.join(root, "JPEGImages")
    return jpeg_dir if os.path.isdir(jpeg_dir) else root


@DATASETS.register(name="VOCDetection")
class VOCDetection(Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        root = data_cfg.IMG_DIR
        self.img_dir = _image_dir(root)
        self.ann_dir = (data_cfg.LABELS.DET_DIR if data_cfg.LABELS else None) \
            or os.path.join(root, "Annotations")
        if data_cfg.INDICES:
            self.ids = _read_ids(data_cfg.INDICES)
        else:
            self.ids = [f[:-4] for f in sorted(os.listdir(self.ann_dir)) if f.endswith(".xml")]
        if not self.ids:
            raise RuntimeError(f"no samples under {root}")

    def __len__(self):
        return len(self.ids)

    def _parse_xml(self, path: str):
        boxes, labels, difficult = [], [], []
        for obj in ET.parse(path).findall("object"):
            name = obj.find("name").text.strip()
            if name not in self.name2id:
                continue
            diff = obj.find("difficult")
            bb = obj.find("bndbox")
            boxes.append([float(bb.find(k).text) - (1 if k in ("xmin", "ymin") else 0)
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            labels.append(self.name2id[name])
            difficult.append(int(diff.text or 0) if diff is not None else 0)
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32), np.asarray(difficult, np.int32))

    def __getitem__(self, idx):
        iid = self.ids[idx]
        path = os.path.join(self.img_dir, iid + ".jpg")
        if not os.path.isfile(path):
            path = os.path.join(self.img_dir, iid + ".png")
        sample = {"image": imread(path), "target": None}
        if self.stage != "infer":
            boxes, labels, difficult = self._parse_xml(os.path.join(self.ann_dir, iid + ".xml"))
            sample["target"] = {"boxes": boxes, "labels": labels, "difficult": difficult}
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="VOCSegmentation")
class VOCSegmentation(Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        root = data_cfg.IMG_DIR
        self.img_dir = _image_dir(root)
        self.seg_dir = (data_cfg.LABELS.SEG_DIR if data_cfg.LABELS else None) \
            or os.path.join(root, "SegmentationClass")
        if data_cfg.INDICES:
            self.ids = _read_ids(data_cfg.INDICES)
        else:
            self.ids = [f[:-4] for f in sorted(os.listdir(self.seg_dir)) if f.endswith(".png")]
        if not self.ids:
            raise RuntimeError(f"no samples under {root}")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        iid = self.ids[idx]
        sample = {"image": imread(os.path.join(self.img_dir, iid + ".jpg")), "target": None}
        if self.stage != "infer":
            sample["target"] = imread_label(os.path.join(self.seg_dir, iid + ".png"))
        return self.transform(sample) if self.transform else sample
