"""Optimizers (counterpart of ``cvpytorch_tpu/optim/optimizers.py``).

The JAX package builds one optax chain: gradient accumulation
(``optax.MultiSteps``) around global-norm or value clipping, coupled L2
decay on weight leaves, a per-group core (SGD, Adam or AdamW) with its own
learning-rate scale, and zero updates for frozen leaves.  The port builds
the same thing on a ``torch.optim`` optimizer whose ``step()`` runs the
chain on the parameters' ``.grad``:

* every parameter gets the JAX leaf label: a leaf named ``bias`` → bias
  group; any other 1-D leaf (BN weight) → norm group; the rest → weight
  group.  Bias and norm groups take ``BIAS_PARAMS``' momentum/nesterov
  (nesterov only if it is set there), weight groups ``WEIGHT_PARAMS``';
* coupled decay (SGD, Adam) is ``weight_decay`` on the weight groups only,
  added after clipping as torch adds it inside ``step``; AdamW decays the
  weight groups decoupled;
* ``BIAS_LR_MULTIPLIER`` scales the bias groups' rate, ``BACKBONE_LR`` the
  rate of parameters under ``backbone``; ``FREEZE_PATTERNS`` (substrings
  of the JAX-style path, e.g. ``backbone/stem/conv/kernel``) leave a
  parameter out of every group, so it never moves, while its gradient
  still counts in the clip norm;
* before every applied update each group's ``lr`` is set to
  ``lr_schedule(count) * scale``, where ``count`` is the number of updates
  applied before it (0 first), as optax counts;
* ``GRAD_CLIP`` norm scales by ``max/‖g‖`` when ``‖g‖ ≥ max``, with no
  epsilon (``optax.clip_by_global_norm``); value clips elementwise;
* ``ACCUMULATE_STEPS`` k averages k gradients with optax's running mean
  and applies once; only applied updates advance ``count``.

SGD, Adam and AdamW are ported; the other names raise.
"""
from __future__ import annotations

import torch

from ..registry import OPTIMIZERS

NOT_PORTED = ("Adadelta", "RMSprop", "RAdam", "AdaBelief", "Ranger")


def leaf_label(name: str, p: torch.Tensor) -> str:
    """'bias', 'norm' (other 1-D leaves) or 'weight'."""
    if name.rsplit(".", 1)[-1] == "bias":
        return "bias"
    return "norm" if p.dim() <= 1 else "weight"


def jax_path(name: str, p: torch.Tensor) -> str:
    """The parameter's path in the JAX tree: ``stage1_down.conv.weight`` →
    ``stage1_down/conv/kernel``, a 1-D ``weight`` → ``scale``."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if p.dim() > 1 else "scale"
    return "/".join(mods + [leaf])


class _Chain:
    """The optax chain around a ``torch.optim`` update (see the module
    docstring).  Mixed in front of SGD, Adam and AdamW."""

    def __init__(self, groups, *, lr_schedule, frozen=(), clip=None,
                 accumulate: int = 1, **defaults):
        super().__init__(groups, **defaults)
        self.lr_schedule = lr_schedule
        self.frozen = list(frozen)
        self.clip = clip  # None, ("norm", max) or ("value", max)
        self.accumulate = max(int(accumulate), 1)
        self.count = 0  # applied updates
        self.mini_step = 0
        self._acc = None

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]] + self.frozen

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none)
        for p in self.frozen:
            p.grad = None

    @torch.no_grad()
    def step(self, closure=None):
        """Runs the chain on the current ``.grad``s.  Returns True when an
        update was applied, False on an accumulation micro-step."""
        if closure is not None:
            raise ValueError("the chain takes no closure")
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.accumulate > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in params]
            n = self.mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            grads, self._acc, self.mini_step = self._acc, None, 0
        if self.clip is not None:
            kind, limit = self.clip
            if kind == "norm":
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                factor = torch.where(norm < limit, 1.0, limit / norm)
                torch._foreach_mul_(grads, factor)
            else:
                torch._foreach_clamp_min_(grads, -limit)
                torch._foreach_clamp_max_(grads, limit)
        for p, g in zip(params, grads):
            p.grad = g
        for group in self.param_groups:
            group["lr"] = self.lr_schedule(self.count) * group["lr_scale"]
        super().step()
        self.count += 1
        return True

    def state_dict(self):
        out = super().state_dict()
        out["chain"] = {"count": self.count, "mini_step": self.mini_step,
                        "acc": self._acc}
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        chain = state_dict.pop("chain")
        super().load_state_dict(state_dict)
        self.count, self.mini_step = int(chain["count"]), int(chain["mini_step"])
        self._acc = None if chain["acc"] is None else [
            a.to(p.device) for a, p in zip(chain["acc"], self._params())]


@OPTIMIZERS.register(name="SGD")
class SGD(_Chain, torch.optim.SGD):
    pass


@OPTIMIZERS.register(name="Adam")
class Adam(_Chain, torch.optim.Adam):
    pass


@OPTIMIZERS.register(name="AdamW")
class AdamW(_Chain, torch.optim.AdamW):
    pass


def build_optimizer(cfg, model: torch.nn.Module, lr_schedule):
    """The optimizer for ``model`` from a trainer config.

    Reads OPTIMIZER.{TYPE, MOMENTUM, BETAS, WEIGHT_DECAY, WEIGHT_PARAMS,
    BIAS_PARAMS, BIAS_LR_MULTIPLIER}, GRAD_CLIP.{TYPE, VALUE},
    ACCUMULATE_STEPS, INIT_LR, BACKBONE_LR and FREEZE_PATTERNS, as the JAX
    ``build_optimizer`` does."""
    opt_cfg = cfg.OPTIMIZER or {}
    get = opt_cfg.get
    opt_type = get("TYPE", "SGD") or "SGD"
    if opt_type in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet (ROADMAP, Queue 1): "
            "the port has SGD, Adam and AdamW")

    kwargs = {}
    if get("MOMENTUM") is not None:
        kwargs["momentum"] = float(get("MOMENTUM"))
    if get("BETAS") is not None:
        kwargs["betas"] = tuple(get("BETAS"))
    wp = get("WEIGHT_PARAMS") or {}
    wd = float(wp.get("weight_decay") or get("WEIGHT_DECAY") or 0.0)
    if wp.get("momentum") is not None:
        kwargs["momentum"] = float(wp.get("momentum"))
    if wp.get("nesterov") is not None:
        kwargs["nesterov"] = bool(wp.get("nesterov"))
    bp = get("BIAS_PARAMS") or {}
    bias_kwargs = dict(kwargs)
    bias_kwargs.pop("nesterov", None)
    if bp.get("momentum") is not None:
        bias_kwargs["momentum"] = float(bp.get("momentum"))
    if bp.get("nesterov") is not None:
        bias_kwargs["nesterov"] = bool(bp.get("nesterov"))
    bias_mult = float(get("BIAS_LR_MULTIPLIER") or 1.0)
    base_lr = float(cfg.INIT_LR or 0.01)
    bb_scale = float(cfg.BACKBONE_LR) / base_lr if cfg.BACKBONE_LR else 1.0

    def hyper(label: str) -> dict:
        kw = kwargs if label == "weight" else bias_kwargs
        decay = wd if label == "weight" else 0.0
        if opt_type == "SGD":
            momentum = kw.get("momentum", 0.9)
            return {"momentum": momentum,
                    "nesterov": bool(kw.get("nesterov", False)) and momentum > 0,
                    "weight_decay": decay}
        return {"betas": kw.get("betas", (0.9, 0.999)), "eps": 1e-8,
                "weight_decay": decay}

    patterns = list(cfg.FREEZE_PATTERNS or [])
    groups: dict[str, dict] = {}
    frozen = []
    for name, p in model.named_parameters():
        path = jax_path(name, p)
        if any(pat in path for pat in patterns):
            frozen.append(p)
            continue
        label = leaf_label(name, p)
        in_backbone = bb_scale != 1.0 and path.startswith("backbone")
        key = ("backbone_" if in_backbone else "") + label
        if key not in groups:
            scale = (bias_mult if label == "bias" else 1.0) * \
                (bb_scale if in_backbone else 1.0)
            groups[key] = {"params": [], "name": key, "lr_scale": scale,
                           "lr": lr_schedule(0) * scale, **hyper(label)}
        groups[key]["params"].append(p)

    clip = None
    clip_cfg = cfg.GRAD_CLIP
    if clip_cfg and clip_cfg.get("VALUE"):
        kind = "norm" if (clip_cfg.get("TYPE") or "norm") == "norm" else "value"
        clip = (kind, float(clip_cfg.get("VALUE")))
    return OPTIMIZERS.get(opt_type)(
        list(groups.values()), lr_schedule=lr_schedule, frozen=frozen,
        clip=clip, accumulate=int(cfg.ACCUMULATE_STEPS or 1),
        lr=lr_schedule(0))
