"""Every name and alias the JAX package resolves from a config resolves in
the port: each registry (models, backbones, necks, heads, detects, losses,
datasets, optimizers, schedules), each task's transform table and the
evaluator factory's names.  None is left unported."""
import importlib
import pkgutil

import pytest

import cvpytorch_tpu
import cvpytorch_tpu.registry as jax_registry
import cvpytorch_tpu_torch.registry as port_registry
from cvpytorch_tpu.data.transforms import _NAMESPACES as JAX_TASKS
from cvpytorch_tpu.data.transforms import _get_namespace as jax_namespace
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data.transforms import _get_namespace as port_namespace
from cvpytorch_tpu_torch.evaluator import build_evaluator

REGISTRIES = ("DATASETS", "MODELS", "BACKBONES", "NECKS", "HEADS", "DETECTS", "LOSSES",
              "EVALUATORS", "OPTIMIZERS", "LR_SCHEDULERS")


class _Dataset:
    num_classes = 3
    dictionary = [{"a": 1.0}, {"b": 1.0}, {"c": 1.0}]
    class_names = ["a", "b", "c"]


def _import_all(pkg, skip=("parallel", "ops.pallas")):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not any(f".{s}" in m.name for s in skip):
            importlib.import_module(m.name)


@pytest.fixture(scope="module")
def registries():
    import cvpytorch_tpu_torch

    _import_all(cvpytorch_tpu)
    _import_all(cvpytorch_tpu_torch)
    return jax_registry, port_registry


@pytest.mark.parametrize("name", REGISTRIES)
def test_every_jax_registry_name_resolves_in_the_port(registries, name):
    jax_reg, port_reg = (getattr(r, name) for r in registries)
    names = sorted(jax_reg.keys())
    if name == "EVALUATORS":  # the port's factory resolves these by name
        for n in names:
            cfg = CommonConfiguration({"EVALUATOR": {"NAME": n}})
            assert build_evaluator(cfg, _Dataset()) is not None, n
        return
    assert names, name
    missing = [n for n in names if n not in port_reg]
    assert not missing, missing


@pytest.mark.parametrize("task", sorted(set(JAX_TASKS.values())))
def test_every_jax_transform_resolves_in_the_port(task):
    port = port_namespace(task)
    missing = []
    for n in jax_namespace(task):
        try:
            port[n]
        except KeyError:
            missing.append(n)
    assert not missing, missing
