"""Transform pipeline builder (counterpart of
``cvpytorch_tpu/data/transforms/__init__.py``).

The task namespace is selected by the dictionary name
(``DATASET.DICTIONARY_NAME``) and the pipeline is the *ordered*
``TRANSFORMS:`` mapping of TransformName → kwargs: the classification,
segmentation, detection (and instance) and keypoint namespaces.
"""
from __future__ import annotations

from typing import Mapping

_NAMESPACES = {"CLS_CLASSES": "cls", "SEG_CLASSES": "seg",
               "DET_CLASSES": "det", "INS_CLASSES": "ins",
               "KEYPOINT_CLASSES": "keypoint"}


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def _get_namespace(task: str) -> dict:
    if task == "cls":
        from .cls_transforms import CLS_TRANSFORMS

        return CLS_TRANSFORMS
    if task == "seg":
        from .seg_transforms import SEG_TRANSFORMS

        return SEG_TRANSFORMS
    if task in ("det", "ins"):
        from .det_transforms import DET_TRANSFORMS

        return DET_TRANSFORMS
    if task == "keypoint":
        from .keypoint_transforms import KEYPOINT_TRANSFORMS

        return KEYPOINT_TRANSFORMS
    raise KeyError(f"no transform namespace for task {task!r} in the port yet")


def build_transforms(dictionary_name: str, transforms_cfg: Mapping,
                     stage: str = "train") -> Compose:
    task = _NAMESPACES.get(dictionary_name, dictionary_name)
    namespace = _get_namespace(task)
    pipeline = []
    for name, kwargs in (transforms_cfg or {}).items():
        cls = namespace[name]
        kwargs = dict(kwargs.items()) if hasattr(kwargs, "items") else (kwargs or {})
        pipeline.append(cls(**kwargs) if isinstance(kwargs, dict) else cls(kwargs))
    return Compose(pipeline)
