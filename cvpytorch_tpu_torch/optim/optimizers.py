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
  epsilon (``optax.clip_by_global_norm``); value clips elementwise.  Under
  tensor parallelism ‖g‖ is the whole model's: the leaves held as blocks
  add their Σg² summed over the model group (``parallel.tensor.sq_norm``);
* ``ACCUMULATE_STEPS`` k averages k gradients with optax's running mean
  and applies once; only applied updates advance ``count``.

SGD, Adam and AdamW run on ``torch.optim``'s; Adadelta, RMSprop, RAdam,
AdaBelief and Ranger are written here as optax 0.2.6 computes them
(``torch.optim``'s differ: RMSprop's eps outside the root, RAdam's
threshold, no belief ``eps_root``, Ranger's lookahead):

* ``Adadelta``: ``scale_by_adadelta(rho=0.9, eps=1e-6)``;
* ``RMSprop``: ``scale_by_rms(decay=0.9, eps)`` (eps inside the root),
  then the rate, then ``trace(momentum)`` (a trace of the scaled updates,
  kept at momentum 0 too);
* ``RAdam``: ``scale_by_radam(b1, b2, eps, eps_root=0, threshold=5)``;
* ``AdaBelief``: ``scale_by_belief(b1, b2, eps=1e-16, eps_root=1e-16)``;
* ``Ranger``: RAdam (betas 0.95, 0.999, eps 1e-5), the rate, then
  ``ema(0.8, debias=False)`` of the updates (not a lookahead), as the JAX
  package chains them.
"""
from __future__ import annotations

import math

import torch

from ..parallel.tensor import sq_norm
from ..registry import OPTIMIZERS


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
                norm = torch.sqrt(sq_norm(grads, params))
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


class _OptaxRule(torch.optim.Optimizer):
    """An optax ``scale_by_*`` rule and ``scale_by_learning_rate`` on each
    parameter of a group, after the coupled decay of the group's
    ``weight_decay`` (``add_decayed_weights``); ``_update`` returns the
    update that is added to the parameter.  Moments follow optax's
    operation order, ``(1 − d)·g^k + d·m``."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, **defaults):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, **defaults))

    @staticmethod
    def moment(state, key, g, decay: float, order: int):
        m = state.get(key)
        new = (1 - decay) * g ** order + (decay * m if m is not None else 0.0)
        state[key] = new
        return new

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                state["count"] = state.get("count", 0) + 1
                p.add_(self._update(g, state, group))


def _radam(g, state, b1: float, b2: float, eps: float, threshold: float = 5.0):
    """``scale_by_radam`` (eps_root 0): the rectified Adam direction once
    the variance's degrees of freedom reach ``threshold``, else the
    bias-corrected first moment."""
    mu = _OptaxRule.moment(state, "mu", g, b1, 1)
    nu = _OptaxRule.moment(state, "nu", g, b2, 2)
    t = state["count"]
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = b2 ** t
    ro = ro_inf - 2 * t * b2t / (1 - b2t)
    mu_hat = mu / (1 - b1 ** t)
    if ro < threshold:
        return mu_hat
    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
    return r * mu_hat / (torch.sqrt(nu / (1 - b2t)) + eps)


class _AdadeltaRule(_OptaxRule):
    def _update(self, g, state, group):
        rho, eps = group["rho"], group["eps"]
        e_g = self.moment(state, "e_g", g, rho, 2)
        prev = state.get("e_x", torch.zeros_like(g))
        u = torch.sqrt(prev + eps) / torch.sqrt(e_g + eps) * g
        self.moment(state, "e_x", u, rho, 2)
        return u * -group["lr"]


class _RMSpropRule(_OptaxRule):
    def _update(self, g, state, group):
        nu = self.moment(state, "nu", g, 0.9, 2)
        u = torch.rsqrt(nu + group["eps"]) * g * -group["lr"]
        trace = state.get("trace")
        trace = u if trace is None else u + group["momentum"] * trace
        state["trace"] = trace
        return trace


class _RAdamRule(_OptaxRule):
    def _update(self, g, state, group):
        b1, b2 = group["betas"]
        return _radam(g, state, b1, b2, group["eps"]) * -group["lr"]


class _AdaBeliefRule(_OptaxRule):
    def _update(self, g, state, group):
        b1, b2 = group["betas"]
        mu = self.moment(state, "mu", g, b1, 1)
        nu = self.moment(state, "nu", g - mu, b2, 2) + group["eps_root"]
        state["nu"] = nu
        t = state["count"]
        u = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + group["eps"])
        return u * -group["lr"]


class _RangerRule(_OptaxRule):
    def _update(self, g, state, group):
        b1, b2 = group["betas"]
        u = _radam(g, state, b1, b2, group["eps"]) * -group["lr"]
        return self.moment(state, "ema", u, 0.8, 1)


@OPTIMIZERS.register(name="Adadelta")
class Adadelta(_Chain, _AdadeltaRule):
    pass


@OPTIMIZERS.register(name="RMSprop")
class RMSprop(_Chain, _RMSpropRule):
    pass


@OPTIMIZERS.register(name="RAdam")
class RAdam(_Chain, _RAdamRule):
    pass


@OPTIMIZERS.register(name="AdaBelief")
class AdaBelief(_Chain, _AdaBeliefRule):
    pass


@OPTIMIZERS.register(name="Ranger")
class Ranger(_Chain, _RangerRule):
    pass


# the JAX constructors' defaults of the hand-written rules (the configs
# set momentum and betas only)
_RULE_DEFAULTS = {
    "Adadelta": {"rho": 0.9, "eps": 1e-6},
    "RMSprop": {"momentum": 0.0, "eps": 1e-8},
    "RAdam": {"betas": (0.9, 0.999), "eps": 1e-8},
    "AdaBelief": {"betas": (0.9, 0.999), "eps": 1e-16, "eps_root": 1e-16},
    "Ranger": {"betas": (0.95, 0.999), "eps": 1e-5},
}


def build_optimizer(cfg, model: torch.nn.Module, lr_schedule):
    """The optimizer for ``model`` from a trainer config.

    Reads OPTIMIZER.{TYPE, MOMENTUM, BETAS, WEIGHT_DECAY, WEIGHT_PARAMS,
    BIAS_PARAMS, BIAS_LR_MULTIPLIER}, GRAD_CLIP.{TYPE, VALUE},
    ACCUMULATE_STEPS, INIT_LR, BACKBONE_LR and FREEZE_PATTERNS, as the JAX
    ``build_optimizer`` does."""
    opt_cfg = cfg.OPTIMIZER or {}
    get = opt_cfg.get
    opt_type = get("TYPE", "SGD") or "SGD"

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
        if opt_type in _RULE_DEFAULTS:
            rule = dict(_RULE_DEFAULTS[opt_type])
            rule.update({k: kw[k] for k in ("momentum", "betas") if k in kw and k in rule})
            return {**rule, "weight_decay": decay}
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
