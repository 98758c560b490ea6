"""Configuration system (counterpart of ``cvpytorch_tpu/config.py``).

* ``Configuration`` — a dict with attribute access and *recursive* update;
  nested dicts become ``Configuration`` instances.
* ``CommonConfiguration`` — adds ``from_yaml`` / ``from_json`` /
  ``from_file`` and the soft-miss behaviour: reading an absent key returns
  ``None`` instead of raising.

``yaml`` is imported only inside the functions that read YAML, so a JSON
config and a JSON dictionary need no PyYAML.
"""
from __future__ import annotations

import json
import logging
from collections import UserDict
from typing import Any, Mapping

logger = logging.getLogger("cvpytorch_tpu_torch")


def _read_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def _read_yaml(path: str):
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def _read_mapping(path: str):
    """Parse a ``.json`` file with ``json`` and anything else as YAML."""
    return _read_json(path) if path.endswith(".json") else _read_yaml(path)


class Configuration(UserDict):
    """Dict with attribute access; nested mappings auto-wrap."""

    def __init__(self, initial: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        if initial:
            self.update(initial)
        if kwargs:
            self.update(kwargs)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name == "data":
            raise AttributeError(name)
        try:
            return self.data[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "data" or name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        self.data[key] = self._wrap(value)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, Configuration):
            return value
        if isinstance(value, Mapping):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def update(self, other=None, **kwargs):  # type: ignore[override]
        merged = {}
        if other:
            merged.update(dict(other))
        merged.update(kwargs)
        for key, value in merged.items():
            if (
                key in self.data
                and isinstance(self.data[key], Configuration)
                and isinstance(value, Mapping)
            ):
                self.data[key].update(value)
            else:
                self[key] = value


class CommonConfiguration(Configuration):
    """Configuration with soft-missing keys and file constructors."""

    _warned: set

    def __init__(self, initial: Mapping[str, Any] | None = None, **kwargs):
        super().__setattr__("_warned", set())
        super().__init__(initial, **kwargs)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name == "data":
            raise AttributeError(name)
        if name in self.data:
            return self.data[name]
        if name not in self._warned:
            self._warned.add(name)
            logger.debug("config key %r missing; returning None", name)
        return None

    def get(self, key, default=None):
        return self.data.get(key, default)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, CommonConfiguration):
            return value
        if isinstance(value, Mapping):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    @classmethod
    def from_yaml(cls, path: str) -> "CommonConfiguration":
        return cls(_read_yaml(path) or {})

    @classmethod
    def from_json(cls, path: str) -> "CommonConfiguration":
        return cls(_read_json(path) or {})

    @classmethod
    def from_file(cls, path: str) -> "CommonConfiguration":
        """``from_json`` for a ``.json`` path, else ``from_yaml``."""
        return cls(_read_mapping(path) or {})


def load_dictionary(path: str, task: str | None = None):
    """Load a class-dictionary file (``conf/dicts/*_dict.yml``, or the same
    mapping as ``.json``).

    Returns ``(task_key, classes)`` — the list under the task key; each
    element is a one-item mapping ``{class_name: loss_weight}``.  ``task``
    (the config's DICTIONARY_NAME) selects a section in multi-task files.
    """
    payload = _read_mapping(path)
    if not isinstance(payload, Mapping) or not payload:
        raise ValueError(f"dictionary file must map task keys: {path}")
    if task is not None and task in payload:
        return task, payload[task]
    if len(payload) != 1:
        raise ValueError(
            f"dictionary file has {len(payload)} task keys; pass the "
            f"DICTIONARY_NAME to select one: {path}")
    (task_key, classes), = payload.items()
    return task_key, classes


def dictionary_to_names_weights(classes: list) -> tuple[list[str], list[float]]:
    """Flatten [{name: weight}, ...] into (names, weights)."""
    names, weights = [], []
    for item in classes:
        if isinstance(item, Mapping):
            (name, weight), = item.items()
        else:
            name, weight = str(item), 1.0
        names.append(name)
        weights.append(float(weight))
    return names, weights
