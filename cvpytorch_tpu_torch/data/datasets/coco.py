"""COCO detection and instance segmentation datasets (counterparts of
``CocoDetection`` and ``CocoSegmentation`` in
``cvpytorch_tpu/data/datasets/coco.py``), registered under the same names.
Images are read by ``image_io.imread`` (the port's JPEG and PNG decoders,
equal to ``cv2.imread``), polygons rasterised by ``imgproc.fill_poly``
(equal to ``cv2.fillPoly``), RLE decoded by the port's host C codec.

* annotations from ``LABELS.DET_DIR`` or ``ANN_FILE`` (an
  ``instances_*.json``); crowd and degenerate (w or h <= 1) boxes and
  categories outside the dictionary are dropped, and at the train stage
  so are the images left with none;
* category ids map to contiguous labels by the dictionary's order (or by
  sorted id without a dictionary);
* ``LOAD_NUM`` > 1 at the train stage: with probability ``MOSAIC_PROB``
  (default 1) an item is ``LOAD_NUM`` samples, the item and
  ``random.randrange`` draws, for the mosaic transform; the ``random``
  calls are the JAX dataset's, in its order;
* ``CACHE``: the split decoded once by 8 threads, kept in memory and
  saved beside ``IMG_DIR`` under a name keyed by the files' paths, sizes
  and modification times;
* ``CocoSegmentation`` adds ``masks``: each instance's polygons or RLE
  rasterised on the image and resized (nearest) to ``MASK_SIZE``².

* ``CocoKeypoint`` adds ``keypoints`` (N, 17, 3) (an annotation without
  them gives zeros) and the annotation ``areas``, which the OKS protocol
  normalises by (the box area where an annotation has no ``area``).
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ... import native
from ...registry import DATASETS
from ..image_io import imread
from ..transforms.imgproc import fill_poly, resize_nearest
from .base import Dataset, MosaicGroups


@DATASETS.register(name="CocoDetection")
class CocoDetection(MosaicGroups, Dataset):
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.img_dir = data_cfg.IMG_DIR
        ann_file = (data_cfg.LABELS.DET_DIR if data_cfg.LABELS else None) or data_cfg.ANN_FILE
        self._read_load_num(data_cfg)

        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        if self.dictionary:
            name_order = {n: i for i, n in enumerate(self.category)}
            self.catid2label = {c["id"]: name_order[c["name"]] for c in cats
                                if c["name"] in name_order}
        else:
            self.catid2label = {c["id"]: i for i, c in enumerate(cats)}

        anns_by_img: dict[int, list] = {}
        for a in coco["annotations"]:
            if a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            if w <= 1 or h <= 1 or a["category_id"] not in self.catid2label:
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.items = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if stage == "train" and not anns:
                continue
            self.items.append({"id": img["id"], "file_name": img["file_name"],
                               "height": img["height"], "width": img["width"], "anns": anns})
        if not self.items:
            raise RuntimeError(f"no usable images in {ann_file}")
        self._cache = self._cache_images() if getattr(data_cfg, "CACHE", None) else None

    def _paths(self) -> list[str]:
        return [os.path.join(self.img_dir, it["file_name"]) for it in self.items]

    def _cache_images(self) -> list:
        paths = self._paths()
        sig = "".join(f"{p}:{os.path.getsize(p)}:{int(os.path.getmtime(p))}"
                      if os.path.isfile(p) else p for p in paths)
        h = hashlib.md5(sig.encode()).hexdigest()
        cache_path = os.path.join(os.path.dirname(os.path.abspath(self.img_dir)),
                                  f"{self.stage}_{h[:12]}.cache.npy")
        if os.path.isfile(cache_path):
            blob = np.load(cache_path, allow_pickle=True).item()
            if blob.get("hash") == h:
                return blob["images"]
        with ThreadPoolExecutor(max_workers=8) as pool:
            images = list(pool.map(imread, paths))
        try:
            np.save(cache_path, {"hash": h, "images": images}, allow_pickle=True)
        except OSError:
            pass  # the directory is read-only: the images stay cached in memory
        return images

    def __len__(self):
        return len(self.items)

    def _load_one(self, idx: int) -> dict:
        item = self.items[idx]
        if self._cache is not None:
            img = self._cache[idx].copy()  # transforms write into the image
        else:
            img = imread(os.path.join(self.img_dir, item["file_name"]))
        boxes, labels = [], []
        for a in item["anns"]:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(self.catid2label[a["category_id"]])
        target = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "image_id": item["id"],
            "height": item["height"],
            "width": item["width"],
        }
        return {"image": img, "target": None if self.stage == "infer" else target}


def rasterize_segmentation(segm, height: int, width: int, out_size: int) -> np.ndarray:
    """COCO polygons, or uncompressed or compressed RLE, → (out_size,
    out_size) float32 0/1 mask: rasterised on the (height, width) image
    (an RLE on its own ``size``) and resized by the nearest rule."""
    mask = np.zeros((height, width), np.uint8)
    if isinstance(segm, list):
        for poly in segm:
            fill_poly(mask, np.asarray(poly, np.float64).reshape(-1, 2).astype(np.int32), 1)
    elif isinstance(segm, dict) and "counts" in segm:
        counts = segm["counts"]
        if isinstance(counts, (str, bytes)):
            counts = native.rle_decode_string(counts)
        h, w = segm.get("size", [height, width])
        mask = native.rle_to_mask(np.asarray(counts, np.int64), h, w)
    return resize_nearest(mask, (out_size, out_size)).astype(np.float32)


@DATASETS.register(name="CocoSegmentation")
class CocoSegmentation(CocoDetection):
    """Detection targets plus per-instance ``masks`` at ``MASK_SIZE``."""

    MASK_SIZE = 112

    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage="train"):
        super().__init__(data_cfg, dictionary, transform, target_transform, stage)
        self.mask_size = int(getattr(data_cfg, "MASK_SIZE", None) or self.MASK_SIZE)

    def _load_one(self, idx: int) -> dict:
        sample = super()._load_one(idx)
        item = self.items[idx]
        if sample["target"] is not None:
            masks = [rasterize_segmentation(a.get("segmentation", []), item["height"],
                                            item["width"], self.mask_size)
                     for a in item["anns"]]
            sample["target"]["masks"] = (
                np.stack(masks) if masks
                else np.zeros((0, self.mask_size, self.mask_size), np.float32))
        return sample


@DATASETS.register(name="CocoKeypoint")
class CocoKeypoint(CocoDetection):
    """Person boxes with their 17 COCO keypoints and annotation areas."""

    def _load_one(self, idx: int) -> dict:
        sample = super()._load_one(idx)
        anns = self.items[idx]["anns"]
        if sample["target"] is not None:
            kps = [np.asarray(a.get("keypoints", [0] * 51), np.float32).reshape(-1, 3)
                   for a in anns]
            sample["target"]["keypoints"] = (
                np.stack(kps) if kps else np.zeros((0, 17, 3), np.float32))
            sample["target"]["areas"] = np.asarray(
                [a.get("area") or (a["bbox"][2] * a["bbox"][3]) for a in anns], np.float32)
        return sample
