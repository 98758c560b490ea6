"""Name → constructor registries.

The reference selects every pluggable component by a string in YAML, resolved
either by ``import_module`` on a dotted path (datasets/models,
reference: trainer.py:87-88,121-124) or by if-elif factory chains
(reference: src/models/backbones/__init__.py:60, src/losses/__init__.py:37).

Here a single explicit :class:`Registry` replaces both.  The SAME yml names
the reference uses ('YOLOv5CSPDarknet', 'CocoDetection', 'CrossEntropyLoss2d',
…) register here, and dotted reference paths like ``src.models.yolov5`` are
accepted for config compatibility — only the final component is looked up.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Callable] = {}

    def register(self, obj: Callable | None = None, *, name: str | None = None,
                 aliases: Iterable[str] = ()):  # usable as decorator or call
        def _do(fn: Callable) -> Callable:
            key = name or fn.__name__
            for k in (key, *aliases):
                if k in self._store and self._store[k] is not fn:
                    raise KeyError(f"{self.name}: duplicate registration {k!r}")
                self._store[k] = fn
            return fn

        if obj is None:
            return _do
        return _do(obj)

    def get(self, key: str) -> Callable:
        # accept reference-style dotted module paths: 'src.models.yolov5'
        # resolves by its final component, case-insensitively as fallback.
        base = key.split(".")[-1]
        for candidate in (key, base):
            if candidate in self._store:
                return self._store[candidate]
        lowered = {k.lower(): v for k, v in self._store.items()}
        if base.lower() in lowered:
            return lowered[base.lower()]
        raise KeyError(
            f"{self.name}: unknown name {key!r}; known: {sorted(self._store)}"
        )

    def __contains__(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def keys(self):
        return self._store.keys()

    def build(self, name: str, /, *args, **kwargs) -> Any:
        return self.get(name)(*args, **kwargs)


DATASETS = Registry("datasets")
TRANSFORMS = Registry("transforms")        # per-task namespaces handled in data.transforms
MODELS = Registry("models")
BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
DETECTS = Registry("detects")
LOSSES = Registry("losses")
EVALUATORS = Registry("evaluators")
OPTIMIZERS = Registry("optimizers")
LR_SCHEDULERS = Registry("lr_schedulers")
