"""Dataset base (counterpart of ``cvpytorch_tpu/data/datasets/base.py``).

Constructor signature ``(data_cfg, dictionary, transform,
target_transform, stage)``; samples are dicts ``{'image': ndarray,
'target': ...}``."""
from __future__ import annotations

import random


class Dataset:
    def __init__(self, data_cfg=None, dictionary=None, transform=None,
                 target_transform=None, stage: str = "train"):
        self.data_cfg = data_cfg
        self.dictionary = dictionary or []
        self.transform = transform
        self.target_transform = target_transform
        self.stage = stage
        if self.dictionary:
            self.num_classes = len(self.dictionary)
            self.category = [k for d in self.dictionary for k in
                             (d.keys() if hasattr(d, "keys") else [str(d)])]
            self.name2id = {n: i for i, n in enumerate(self.category)}
            self.id2name = {i: n for n, i in self.name2id.items()}

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        raise NotImplementedError


class MosaicGroups:
    """``LOAD_NUM`` > 1 at the train stage: with probability
    ``MOSAIC_PROB`` (default 1) an item is ``LOAD_NUM`` samples, the item
    and ``random.randrange`` draws, for the mosaic transform (the JAX
    ``CocoDetection``'s ``random`` calls, in its order); any other item is
    one sample.  The class supplies ``_load_one(idx)``."""

    def _read_load_num(self, data_cfg) -> None:
        self.load_num = int(getattr(data_cfg, "LOAD_NUM", None) or 1)
        self.mosaic_prob = float(getattr(data_cfg, "MOSAIC_PROB", None)
                                 or (1.0 if self.load_num > 1 else 0.0))

    def __getitem__(self, idx: int):
        if self.stage == "train" and self.load_num > 1 and random.random() < self.mosaic_prob:
            extra = [random.randrange(len(self)) for _ in range(self.load_num - 1)]
            samples = [self._load_one(i) for i in [idx, *extra]]
            return self.transform(samples) if self.transform else samples
        sample = self._load_one(idx)
        return self.transform(sample) if self.transform else sample
