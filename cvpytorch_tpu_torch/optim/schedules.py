"""Learning-rate schedules (counterpart of ``cvpytorch_tpu/optim/schedules.py``).

One per-iteration schedule ``step -> lr`` (a plain Python function), with
the warmup joined in front as ``optax.join_schedules`` joins it: after
``ITERS`` warmup steps the main schedule starts again from its own step
0, so LambdaLR's epoch is ``(step - ITERS) // iters_per_epoch``.  The
linear warmup holds its end value after ``ITERS`` steps, as
``optax.linear_schedule`` does.

Names mirror the YAML ``LR_SCHEDULER.TYPE``: MultiStepLR, StepLR,
CosineAnnealingLR, PolyLR, LambdaLR (alias YoloCosineLR), ExponentialLR;
warmup methods constant/linear/exp.
"""
from __future__ import annotations

import math
from typing import Callable

from ..registry import LR_SCHEDULERS

Schedule = Callable[[int], float]


def _warmup(method: str, base_lr: float, warmup_iters: int,
            factor: float = 1.0 / 3) -> Schedule:
    method = (method or "linear").lower()
    if method == "constant":
        return lambda step: base_lr * factor
    if method == "linear":
        init = base_lr * factor

        def sched(step):
            frac = 1.0 - min(max(step, 0), warmup_iters) / warmup_iters
            return (init - base_lr) * frac + base_lr
        return sched
    if method == "exp":
        def sched(step):
            alpha = step / max(warmup_iters, 1)
            return base_lr * (factor ** (1.0 - alpha))
        return sched
    raise ValueError(f"unknown warmup method {method!r}")


@LR_SCHEDULERS.register(name="MultiStepLR")
def multi_step_lr(base_lr, iters_per_epoch, epochs, milestones=(30, 60, 90),
                  gamma=0.1, **_):
    """``optax.piecewise_constant_schedule``: × gamma from each milestone
    step on (milestones in epochs)."""
    bounds = sorted({int(m * iters_per_epoch) for m in milestones})

    def sched(step):
        return base_lr * gamma ** sum(1 for b in bounds if step >= b)
    return sched


@LR_SCHEDULERS.register(name="StepLR")
def step_lr(base_lr, iters_per_epoch, epochs, step_size=30, gamma=0.1, **_):
    def sched(step):
        epoch = step // iters_per_epoch
        return base_lr * gamma ** (epoch // step_size)
    return sched


@LR_SCHEDULERS.register(name="CosineAnnealingLR")
def cosine_lr(base_lr, iters_per_epoch, epochs, eta_min=0.0, **_):
    """``optax.cosine_decay_schedule`` over every iteration, floor eta_min."""
    total = max(int(iters_per_epoch * epochs), 1)
    alpha = eta_min / max(base_lr, 1e-12)

    def sched(step):
        frac = min(max(step, 0), total) / total
        cosine = 0.5 * (1 + math.cos(math.pi * frac))
        return base_lr * ((1 - alpha) * cosine + alpha)
    return sched


@LR_SCHEDULERS.register(name="PolyLR")
def poly_lr(base_lr, iters_per_epoch, epochs, power=0.9, eta_min=0.0, **_):
    total = max(int(iters_per_epoch * epochs), 1)

    def sched(step):
        frac = 1.0 - min(step, total) / total
        return (base_lr - eta_min) * (frac ** power) + eta_min
    return sched


@LR_SCHEDULERS.register(name="LambdaLR", aliases=("YoloCosineLR",))
def yolo_cosine_lr(base_lr, iters_per_epoch, epochs, lrf=0.2, **_):
    """YOLO one-cycle cosine lambda, stepped per epoch:
    lr(e) = base · ((1 + cos(e·π/E))/2 · (1 − lrf) + lrf)."""
    def sched(step):
        epoch = step // max(iters_per_epoch, 1)
        cos = (1 + math.cos(epoch * math.pi / max(epochs, 1))) / 2
        return base_lr * (cos * (1 - lrf) + lrf)
    return sched


@LR_SCHEDULERS.register(name="ExponentialLR")
def exponential_lr(base_lr, iters_per_epoch, epochs, gamma=0.95, **_):
    def sched(step):
        epoch = step // max(iters_per_epoch, 1)
        return base_lr * gamma ** epoch
    return sched


def build_lr_scheduler(cfg, iters_per_epoch: int) -> Schedule:
    """cfg: the full trainer config (uses INIT_LR, N_MAX_EPOCHS,
    LR_SCHEDULER.{TYPE,...}, WARMUP.{NAME,ITERS,FACTOR})."""
    base_lr = float(cfg.INIT_LR)
    epochs = int(cfg.N_MAX_EPOCHS or 1)
    sch_cfg = dict(cfg.LR_SCHEDULER or {})
    name = sch_cfg.get("TYPE") or "CosineAnnealingLR"
    kwargs = {k.lower(): v for k, v in sch_cfg.items() if k != "TYPE"}
    main = LR_SCHEDULERS.get(name)(base_lr, iters_per_epoch, epochs, **kwargs)

    warm_cfg = cfg.WARMUP
    if warm_cfg and int(warm_cfg.get("ITERS", 0) or 0) > 0:
        iters = int(warm_cfg.get("ITERS"))
        warm = _warmup(warm_cfg.get("NAME", "linear"), base_lr, iters,
                       float(warm_cfg.get("FACTOR", 1.0 / 3) or 1.0 / 3))
        return lambda step: warm(step) if step < iters else main(step - iters)
    return main
