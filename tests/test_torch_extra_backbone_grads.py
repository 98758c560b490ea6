"""Train-mode gradients of the seven backbones the port took last
against the JAX modules on the CPU (the forward checks and the weights:
``tests/test_torch_extra_backbones.py``): per-leaf gradients of a fixed
random projection of the outputs, float64 on both sides, within 1e-6 of
the leaf's largest gradient (or 1e-3 of the largest of all), at 64²: at
32² the last stages' train-mode BN normalises 2 samples of 1×1 maps, and
gradients there reach 1e8 with float64 rounding amplified to 1e-5.
Stochastic depth and dropout are at 0: JAX draws their masks from its own
RNG."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, port_name
from tests.test_torch_extra_backbones import GRAD_HW, NO_DROP, images, make_pair
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)


def projection(outs, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(*np.shape(o)) for o in outs]


@pytest.mark.parametrize("case", ["convnext_t", "regnet_y_400mf", "mobilenet_v3_small",
                                  "tinynet", "squeezenet1_1", "densenet121", "vit_t_16"])
def test_train_mode_grads_match_jax_in_float64(case):
    """Classifier mode, except SqueezeNet (its classifier's dropout is
    fixed at 0.5): the feature maps."""
    classifier = case != "squeezenet1_1"
    jm, variables, tm = make_pair(case, classifier, NO_DROP.get(case), hw=GRAD_HW)
    x = images(seed=2, hw=GRAD_HW).astype(np.float64)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

    def jax_loss(params, ws):
        out, _ = jm.apply({**as64, "params": params}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        outs = [out] if classifier else list(out)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jm.apply(as64, jnp.asarray(x)))
        ws = projection([shapes] if classifier else list(shapes))
        jgrads = jax.jit(jax.grad(jax_loss))(as64["params"], [jnp.asarray(w) for w in ws])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = copy.deepcopy(tm).double().train()
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    outs = [out] if classifier else list(out)
    loss = sum((o if o.dim() < 4 else o.permute(0, 2, 3, 1)).mul(torch.from_numpy(w)).sum()
               for o, w in zip(outs, ws))
    loss.backward()
    owners, params = dict(tm.named_modules()), dict(tm.named_parameters())
    pairs = []
    for path, g in _flatten(jgrads):
        assert g.dtype == np.float64
        name = port_name("params", path, params)
        want = _convert(name, g, params[name], owners.get(".".join(path[:-1])))
        pairs.append((name, want, params[name].grad.numpy()))
    assert len(pairs) == len(params)
    gmax = max(np.abs(w).max() for _, w, _ in pairs)
    worst = max((float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-3 * gmax)), n)
                for n, w, g in pairs)
    assert worst[0] <= 1e-6, worst
