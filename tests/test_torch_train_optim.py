"""The port's schedules and optimizer chain against optax.

Schedules: every type, with each warmup, at steps around the warmup and
epoch boundaries, within 1e-7 relative.  The port computes a schedule in
float64 Python; JAX is held to it with x64 on, so that both evaluate the
same formulas in float64 (in JAX's default float32 its own rounding
differs from the exact value by up to 8 ulps, 7.3e-7 relative, on these
steps).  Optimizer: the same synthetic
gradients (numpy seeds) over several steps across the warmup boundary,
parameters within 1e-6 of ``optax.apply_updates`` after every step, for
the groupings, clipping, accumulation and optimizer types the configs use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.optim.optimizers import build_optimizer as jax_build_optimizer
from cvpytorch_tpu.optim.schedules import build_lr_scheduler as jax_build_lr
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler

SCHEDULES = [
    {"TYPE": "MultiStepLR", "MILESTONES": [1, 3], "GAMMA": 0.1},
    {"TYPE": "StepLR", "STEP_SIZE": 2, "GAMMA": 0.5},
    {"TYPE": "CosineAnnealingLR", "ETA_MIN": 1e-4},
    {"TYPE": "PolyLR", "POWER": 0.9},
    {"TYPE": "LambdaLR", "LRF": 0.1},
    {"TYPE": "ExponentialLR", "GAMMA": 0.9},
]
WARMUPS = [None, {"NAME": "linear", "ITERS": 7, "FACTOR": 0.1},
           {"NAME": "constant", "ITERS": 7, "FACTOR": 0.25},
           {"NAME": "exp", "ITERS": 7, "FACTOR": 0.1}]


@pytest.mark.parametrize("warmup", WARMUPS, ids=["none", "linear", "constant", "exp"])
@pytest.mark.parametrize("sched", SCHEDULES, ids=[s["TYPE"] for s in SCHEDULES])
def test_schedule_matches_optax(sched, warmup):
    body = {"INIT_LR": 0.01, "N_MAX_EPOCHS": 5, "LR_SCHEDULER": sched}
    if warmup:
        body["WARMUP"] = warmup
    ipe = 4
    want = jax_build_lr(JaxConfig(body), ipe)
    got = build_lr_scheduler(CommonConfiguration(body), ipe)
    # up to the last step of training (5 epochs of 4): beyond it JAX's
    # PolyLR takes a negative power of a traced step (NaN) and its Python
    # path clamps; the port clamps
    steps = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 16, 19, 20)
    with jax.enable_x64(True):
        for s in steps:
            w = float(want(jnp.asarray(s)))
            np.testing.assert_allclose(got(s), w, rtol=1e-7, err_msg=f"step {s}")


class Toy(nn.Module):
    """Leaves of every label: conv kernels (weight), BN scale (norm), BN
    and conv biases (bias), a linear kernel; under ``backbone`` and not."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.conv = nn.Conv2d(3, 4, 3, bias=False)
        self.backbone.bn = nn.BatchNorm2d(4)
        self.neck = nn.Module()
        self.neck.fc = nn.Linear(4, 5)
        self.head = nn.Module()
        self.head.conv = nn.Conv2d(5, 6, 1)


def to_jax(name, a):
    """Port layout → JAX layout (conv OIHW → HWIO, linear (o,i) → (i,o))."""
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if a.ndim == 2 else a


def jax_tree(flat):
    """{'backbone.conv.weight': arr} → nested JAX tree with JAX leaf names."""
    tree = {}
    for name, a in flat.items():
        *mods, leaf = name.split(".")
        if leaf == "weight":
            leaf = "kernel" if a.ndim > 1 else "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(to_jax(name, a))
    return tree


def jax_leaf(tree, name, ndim):
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim > 1 else "scale"
    for m in mods:
        tree = tree[m]
    return np.asarray(tree[leaf])


FLAGSHIP = {"TYPE": "SGD", "MOMENTUM": 0.937,
            "WEIGHT_PARAMS": {"weight_decay": 5e-4, "nesterov": True}}
CASES = {
    "sgd_flagship_clip": dict(OPTIMIZER=FLAGSHIP, GRAD_CLIP={"TYPE": "norm", "VALUE": 10.0}),
    "sgd_bias_params": dict(OPTIMIZER={**FLAGSHIP, "BIAS_PARAMS": {"momentum": 0.8, "nesterov": True}}),
    "sgd_bias_lr_x2": dict(OPTIMIZER={**FLAGSHIP, "BIAS_LR_MULTIPLIER": 2}),
    "sgd_backbone_lr": dict(OPTIMIZER=FLAGSHIP, BACKBONE_LR=0.002),
    "sgd_freeze": dict(OPTIMIZER=FLAGSHIP, FREEZE_PATTERNS=["backbone/bn", "head/conv/bias"]),
    "sgd_clip_norm_triggers": dict(OPTIMIZER=FLAGSHIP, GRAD_CLIP={"TYPE": "norm", "VALUE": 1.0}),
    "sgd_clip_value": dict(OPTIMIZER=FLAGSHIP, GRAD_CLIP={"TYPE": "value", "VALUE": 0.5}),
    "sgd_accumulate_2": dict(OPTIMIZER=FLAGSHIP, ACCUMULATE_STEPS=2,
                             GRAD_CLIP={"TYPE": "norm", "VALUE": 1.0}),
    "adam": dict(OPTIMIZER={"TYPE": "Adam", "WEIGHT_DECAY": 1e-3}),
    "adamw": dict(OPTIMIZER={"TYPE": "AdamW", "BETAS": [0.8, 0.99],
                             "WEIGHT_PARAMS": {"weight_decay": 0.05}},
                  BIAS_LR_MULTIPLIER=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_updates_match_optax(case):
    """6 steps (3 applied with ACCUMULATE_STEPS 2), warmup of 2 steps, 2
    iterations an epoch: parameters within 1e-6 after every step."""
    body = {"INIT_LR": 0.01, "N_MAX_EPOCHS": 4,
            "LR_SCHEDULER": {"TYPE": "LambdaLR", "LRF": 0.1},
            "WARMUP": {"NAME": "linear", "ITERS": 2, "FACTOR": 0.1}, **CASES[case]}
    torch.manual_seed(0)
    model = Toy()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    params = jax_tree({n: p.detach().numpy().copy() for n, p in model.named_parameters()})

    jcfg = JaxConfig(body)
    tx = jax_build_optimizer(jcfg, jax_build_lr(jcfg, 2))
    opt_state = tx.init(params)
    cfg = CommonConfiguration(body)
    opt = build_optimizer(cfg, model, build_lr_scheduler(cfg, 2))

    for step in range(6):
        grads = {n: (rng.randn(*p.shape) * 2).astype(np.float32)
                 for n, p in model.named_parameters()}
        updates, opt_state = tx.update(jax_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        for n, p in model.named_parameters():
            want = jax_leaf(params, n, p.dim())
            np.testing.assert_allclose(to_jax(n, p.detach().numpy()), want,
                                       atol=1e-6, rtol=0, err_msg=f"{case} step {step} {n}")
    if case == "sgd_freeze":
        grouped = {id(p) for g in opt.param_groups for p in g["params"]}
        assert {n for n, p in model.named_parameters() if id(p) not in grouped} == \
            {"backbone.bn.weight", "backbone.bn.bias", "head.conv.bias"}


def test_not_ported_optimizers_raise():
    """The five optimizers the port once refused build now, as hand-written
    optax rules (their updates: tests/test_torch_optim_rules.py); a type
    of neither package still raises."""
    for name in ("Adadelta", "RMSprop", "RAdam", "AdaBelief", "Ranger"):
        cfg = CommonConfiguration({"INIT_LR": 0.01, "OPTIMIZER": {"TYPE": name}})
        opt = build_optimizer(cfg, Toy(), lambda s: 0.01)
        assert type(opt).__name__ == name and not isinstance(opt, torch.optim.Adam)
    cfg = CommonConfiguration({"INIT_LR": 0.01, "OPTIMIZER": {"TYPE": "Lion"}})
    with pytest.raises(KeyError, match="Lion"):
        build_optimizer(cfg, Toy(), lambda s: 0.01)


def test_lr_of_the_first_update_is_lr_at_zero():
    """optax counts before it increments: update k uses lr(k)."""
    body = {"INIT_LR": 0.01, "N_MAX_EPOCHS": 2, "OPTIMIZER": {"TYPE": "SGD"},
            "WARMUP": {"NAME": "linear", "ITERS": 4, "FACTOR": 0.1}}
    cfg = CommonConfiguration(body)
    sched = build_lr_scheduler(cfg, 2)
    model = Toy()
    opt = build_optimizer(cfg, model, sched)
    seen = []
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        seen.append(opt.param_groups[0]["lr"])
    assert seen == [sched(0), sched(1), sched(2)]
    assert seen[0] == pytest.approx(0.001)
