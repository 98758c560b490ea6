"""Dataset base (counterpart of ``cvpytorch_tpu/data/datasets/base.py``).

Constructor signature ``(data_cfg, dictionary, transform,
target_transform, stage)``; samples are dicts ``{'image': ndarray,
'target': ...}``."""
from __future__ import annotations


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
