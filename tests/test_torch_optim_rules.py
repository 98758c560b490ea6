"""The port's hand-written optax rules (Adadelta, RMSprop, RAdam, AdaBelief,
Ranger) against the JAX package's ``build_optimizer`` (optax 0.2.6) in
float64: the same synthetic gradients (numpy seeds) over 7 steps, across
a warmup and RAdam's switch to the rectified update (its variance's
degrees of freedom pass 5 at step 6), in the port's parameter groups,
decay masks and clipping, both on the JAX schedule's values (float32
there even under x64).  Parameters within 1e-12 of
``optax.apply_updates`` after every step (XLA's float64 ``rsqrt`` and
``pow`` may differ from torch's in the last bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.optim.optimizers import build_optimizer as jax_build_optimizer
from cvpytorch_tpu.optim.schedules import build_lr_scheduler as jax_build_lr
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from tests.test_torch_train_optim import Toy, jax_leaf, jax_tree, to_jax

CASES = {
    "adadelta": dict(OPTIMIZER={"TYPE": "Adadelta", "WEIGHT_DECAY": 1e-3}),
    "rmsprop": dict(OPTIMIZER={"TYPE": "RMSprop"}),
    "rmsprop_momentum_clip": dict(OPTIMIZER={"TYPE": "RMSprop", "MOMENTUM": 0.9,
                                             "WEIGHT_PARAMS": {"weight_decay": 5e-4}},
                                  GRAD_CLIP={"TYPE": "norm", "VALUE": 3.0}),
    "radam": dict(OPTIMIZER={"TYPE": "RAdam", "BETAS": [0.8, 0.99], "WEIGHT_DECAY": 1e-3}),
    "adabelief_bias_lr": dict(OPTIMIZER={"TYPE": "AdaBelief", "BIAS_LR_MULTIPLIER": 2,
                                         "WEIGHT_DECAY": 1e-3}),
    # (a BACKBONE_LR scale rounds JAX's rates to float32 a second time)
    "ranger_freeze": dict(OPTIMIZER={"TYPE": "Ranger", "WEIGHT_DECAY": 1e-3},
                          FREEZE_PATTERNS=["backbone/bn"], GRAD_CLIP={"TYPE": "value", "VALUE": 1.0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rule_updates_match_optax_float64(case):
    body = {"INIT_LR": 0.01, "N_MAX_EPOCHS": 4,
            "LR_SCHEDULER": {"TYPE": "CosineAnnealingLR"},
            "WARMUP": {"NAME": "linear", "ITERS": 2, "FACTOR": 0.1}, **CASES[case]}
    model = Toy().double()
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape)))
    with jax.enable_x64(True):
        params = jax_tree({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
        jcfg = JaxConfig(body)
        jax_lr = jax_build_lr(jcfg, 2)
        tx = jax_build_optimizer(jcfg, jax_lr)
        # JAX's schedule is float32 under x64 too: both sides take its values
        # (the schedules themselves: tests/test_torch_train_optim.py)
        lr = [float(jax_lr(jnp.asarray(s, jnp.int32))) for s in range(7)]
        opt = build_optimizer(CommonConfiguration(body), model, lambda s: lr[s])
        opt_state = tx.init(params)
        update = jax.jit(tx.update)
        for step in range(7):
            grads = {n: rng.randn(*p.shape) * 2 for n, p in model.named_parameters()}
            updates, opt_state = update(jax_tree(grads), opt_state, params)
            params = optax.apply_updates(params, updates)
            opt.zero_grad()
            for n, p in model.named_parameters():
                p.grad = torch.from_numpy(grads[n].copy())  # the clip scales it in place
            opt.step()
            for n, p in model.named_parameters():
                want = jax_leaf(params, n, p.dim())
                np.testing.assert_allclose(to_jax(n, p.detach().numpy()), want, atol=1e-12,
                                           rtol=0, err_msg=f"{case} step {step} {n}")
    assert type(opt).__name__ == body["OPTIMIZER"]["TYPE"]
    assert all(isinstance(v, torch.Tensor) or k == "count"
               for s in opt.state.values() for k, v in s.items())
