"""The remaining datasets of the JAX package (counterparts of
``cvpytorch_tpu/data/datasets/misc_datasets.py``), registered under the
same names and aliases.  Images are read by ``image_io.imread`` (the
port's JPEG and PNG decoders, equal to ``cv2.imread``), label maps by
``image_io.imread_label``.

* ``_PairedSegDataset``: the images under ``IMG_DIR`` (a recursive sorted
  glob of ``IMG_SUFFIX``, default ``*`` + the class's suffix), each mask
  the image's relative path with the mask suffix under ``LABELS.SEG_DIR``,
  or beside the image without one (Camvid's ``.png`` images are then their
  own masks, read as OpenCV's gray);
  ``ADE20KSegmentation`` (1-based masks: minus 1, negatives → 255),
  ``CamvidSegmentation`` (``.png`` images), ``PortraitSegmentation``;
* ``VisDroneDetection``: ``x,y,w,h,score,category,...`` txt files under
  ``LABELS.DET_DIR`` or ``IMG_DIR`` with ``images`` → ``annotations``;
  categories 0 (ignored regions) and above the dictionary's length and
  boxes under 2 px dropped, label ``category − 1``.  ``LOAD_NUM`` groups
  for the mosaic as ``CocoDetection`` draws them (``MosaicGroups``), which
  the JAX dataset lacks: there ``conf/visdrone_yolov5.yml``'s mosaic gets
  single samples of their own sizes, which do not batch;
* ``VisDroneTrack``: VisDrone-MOT ``sequences/<seq>/*.jpg`` with
  ``annotations/<seq>.txt`` rows ``frame,id,x,y,w,h,score,category,...``,
  one frame an item, with ``track_ids``;
* ``WiderFaceDetection``: the ``wider_face_*_bbx_gt.txt`` list (path,
  count, ``x y w h ...`` rows; a count of 0 is followed by one dummy row),
  boxes kept where w > 2 and h > 2, label 0;
* ``PennFudanDetection``: ``PNGImages/*.png`` and ``PedMasks/*_mask.png``
  instance maps: one box ``[xmin, ymin, xmax + 1, ymax + 1]`` and one
  112² mask (``imgproc.resize_nearest``, OpenCV's INTER_NEAREST) per
  nonzero id, label 0.
"""
from __future__ import annotations

import glob as globlib
import os

import numpy as np

from ...registry import DATASETS
from ..image_io import imread, imread_label
from ..transforms.imgproc import resize_nearest
from .base import Dataset, MosaicGroups


def _det_target(boxes, labels, **extra) -> dict:
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32), **extra}


class _PairedSegDataset(Dataset):
    IMG_SUFFIX = ".jpg"
    MASK_SUFFIX = ".png"
    MASK_OFFSET = 0  # subtracted from the raw mask ids (ADE20K is 1-based)

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        img_dir = data_cfg.IMG_DIR
        seg_dir = (data_cfg.LABELS.SEG_DIR if data_cfg.LABELS else None) or img_dir
        suffix = data_cfg.IMG_SUFFIX or ("*" + self.IMG_SUFFIX)
        self._imgs = sorted(globlib.glob(os.path.join(img_dir, "**", suffix), recursive=True))
        self._masks = [os.path.join(seg_dir, os.path.splitext(os.path.relpath(p, img_dir))[0]
                                    + self.MASK_SUFFIX) for p in self._imgs]
        if not self._imgs:
            raise RuntimeError(f"no images under {img_dir}")

    def __len__(self):
        return len(self._imgs)

    def __getitem__(self, idx):
        sample = {"image": imread(self._imgs[idx]), "target": None}
        if self.stage != "infer":
            mask = imread_label(self._masks[idx])
            if self.MASK_OFFSET:
                mask = mask.astype(np.int32) - self.MASK_OFFSET
                mask = np.where(mask < 0, 255, mask).astype(np.uint8)
            sample["target"] = mask
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="ADE20KSegmentation", aliases=("ADE20K",))
class ADE20KSegmentation(_PairedSegDataset):
    MASK_OFFSET = 1


@DATASETS.register(name="CamvidSegmentation", aliases=("Camvid",))
class CamvidSegmentation(_PairedSegDataset):
    IMG_SUFFIX = ".png"


@DATASETS.register(name="PortraitSegmentation", aliases=("Portrait",))
class PortraitSegmentation(_PairedSegDataset):
    pass


@DATASETS.register(name="VisDroneDetection")
class VisDroneDetection(MosaicGroups, Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self._read_load_num(data_cfg)
        img_dir = data_cfg.IMG_DIR
        ann_dir = (data_cfg.LABELS.DET_DIR if data_cfg.LABELS else None) or \
            img_dir.replace("images", "annotations")
        self._imgs = sorted(globlib.glob(os.path.join(img_dir, "*.jpg")))
        self._anns = [os.path.join(ann_dir, os.path.splitext(os.path.basename(p))[0] + ".txt")
                      for p in self._imgs]
        if not self._imgs:
            raise RuntimeError(f"no images under {img_dir}")

    def __len__(self):
        return len(self._imgs)

    def _read_annotations(self, path: str) -> dict:
        boxes, labels = [], []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.strip().rstrip(",").split(",")
                    if len(parts) < 6:
                        continue
                    x, y, w, h, _, cat = (float(v) for v in parts[:6])
                    if cat < 1 or cat > len(self.dictionary) or w < 2 or h < 2:
                        continue
                    boxes.append([x, y, x + w, y + h])
                    labels.append(int(cat) - 1)
        return _det_target(boxes, labels)

    def _load_one(self, idx: int) -> dict:
        sample = {"image": imread(self._imgs[idx]), "target": None}
        if self.stage != "infer":
            sample["target"] = self._read_annotations(self._anns[idx])
        return sample


@DATASETS.register(name="VisDroneTrack")
class VisDroneTrack(Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        root = data_cfg.IMG_DIR
        seq_dir = os.path.join(root, "sequences")
        ann_dir = (data_cfg.LABELS.DET_DIR if data_cfg.LABELS else None) or \
            os.path.join(root, "annotations")
        self._frames = []  # (image path, sequence, frame number)
        self._anns = {}    # (sequence, frame number) → [(track id, box, label)]
        for seq in sorted(os.listdir(seq_dir)) if os.path.isdir(seq_dir) else []:
            sdir = os.path.join(seq_dir, seq)
            if not os.path.isdir(sdir):
                continue
            for p in sorted(globlib.glob(os.path.join(sdir, "*.jpg"))):
                self._frames.append((p, seq, int(os.path.splitext(os.path.basename(p))[0])))
            ann = os.path.join(ann_dir, seq + ".txt")
            if os.path.exists(ann):
                self._read_sequence(ann, seq)
        if not self._frames:
            raise RuntimeError(f"no sequences under {seq_dir}")

    def _read_sequence(self, path: str, seq: str) -> None:
        with open(path) as f:
            for line in f:
                parts = line.strip().rstrip(",").split(",")
                if len(parts) < 8:
                    continue
                fno, tid = int(parts[0]), int(parts[1])
                x, y, w, h = (float(v) for v in parts[2:6])
                cat = int(float(parts[7]))
                if cat < 1 or w < 2 or h < 2:
                    continue  # 0: ignored regions
                self._anns.setdefault((seq, fno), []).append((tid, [x, y, x + w, y + h],
                                                             cat - 1))

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, idx):
        path, seq, fno = self._frames[idx]
        sample = {"image": imread(path), "target": None}
        if self.stage != "infer":
            nc = max(len(self.dictionary or ()), 1)
            rows = [r for r in self._anns.get((seq, fno), []) if r[2] < nc]
            sample["target"] = _det_target([r[1] for r in rows], [r[2] for r in rows],
                                           track_ids=np.asarray([r[0] for r in rows], np.int32))
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="WiderFaceDetection", aliases=("WiderFace",))
class WiderFaceDetection(Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.img_dir = data_cfg.IMG_DIR
        ann_file = (data_cfg.LABELS.DET_DIR if data_cfg.LABELS else None) or data_cfg.ANN_FILE
        with open(ann_file) as f:
            lines = [line.strip() for line in f]
        self.items = []
        i = 0
        while i < len(lines):
            n = int(lines[i + 1]) if i + 1 < len(lines) else 0
            boxes = []
            for j in range(n):
                x, y, w, h = (float(v) for v in lines[i + 2 + j].split()[:4])
                if w > 2 and h > 2:
                    boxes.append([x, y, x + w, y + h])
            self.items.append((lines[i], np.asarray(boxes, np.float32).reshape(-1, 4)))
            i += 2 + max(n, 1)  # a count of 0 is followed by one row of zeros
        if not self.items:
            raise RuntimeError(f"empty annotation file {ann_file}")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, boxes = self.items[idx]
        sample = {"image": imread(os.path.join(self.img_dir, path)), "target": None}
        if self.stage != "infer":
            sample["target"] = _det_target(boxes.copy(), np.zeros(len(boxes), np.int32))
        return self.transform(sample) if self.transform else sample


@DATASETS.register(name="PennFudanDetection", aliases=("PennFudan",))
class PennFudanDetection(Dataset):
    MASK_SIZE = 112

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        root = data_cfg.IMG_DIR
        self._imgs = sorted(globlib.glob(os.path.join(root, "PNGImages", "*.png")))
        self._masks = [p.replace("PNGImages", "PedMasks").replace(".png", "_mask.png")
                       for p in self._imgs]
        if not self._imgs:
            raise RuntimeError(f"no images under {root}")

    def __len__(self):
        return len(self._imgs)

    def _instances(self, path: str) -> dict:
        mask = imread_label(path)
        ids = np.unique(mask)
        boxes, insts = [], []
        for i in ids[ids != 0]:
            m = mask == i
            ys, xs = np.where(m)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            insts.append(resize_nearest(m.astype(np.float32), (self.MASK_SIZE, self.MASK_SIZE)))
        masks = (np.stack(insts) if insts
                 else np.zeros((0, self.MASK_SIZE, self.MASK_SIZE), np.float32))
        return _det_target(boxes, np.zeros(len(boxes), np.int32), masks=masks)

    def __getitem__(self, idx):
        sample = {"image": imread(self._imgs[idx]), "target": None}
        if self.stage != "infer":
            sample["target"] = self._instances(self._masks[idx])
        return self.transform(sample) if self.transform else sample
