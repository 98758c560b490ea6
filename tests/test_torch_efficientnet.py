"""The port's EfficientNet (B0–B7 and Lite0: the MBConv blocks, their
squeeze-excitation of the block input's width, stochastic depth, the
classifier form) against the JAX package on the CPU, with one set of
weights carried across by ``load_jax_variables``.

The JAX EfficientNet draws stochastic depth in every train-mode call: the
train-mode check replaces the ``DropPath`` name of
``cvpytorch_tpu.models.backbones.efficientnet`` with an identity in this
test process (``test_torch_efficientdet.jax_without_drop_path``; no JAX
file changes) and sets the port's rates to 0;
``test_drop_path_rates_and_whole_samples`` holds the port's own per-block
rates and draws.

Tolerances: within 1e-5 of the largest output (float32, eval mode); the
train-mode features 1e-9 and every gradient leaf 1e-6 of its largest
value (float64, at 64²: XLA runs float64 depthwise convolutions slowly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones import efficientnet as jax_effnet
from cvpytorch_tpu_torch.models.backbones.efficientnet import EfficientNet
from cvpytorch_tpu_torch.models.bricks import DropPath
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables, port_name
from tests.test_torch_efficientdet import jax_without_drop_path, nhwc, no_drop  # noqa: F401
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import B, as64, images


def test_efficientnet_b0_matches_jax():
    """C3–C5 (strides 8, 16, 32) of B0, eval mode; the SE squeeze width is
    max(1, block input // 4)."""
    x = images(64)
    jm = jax_effnet.EfficientNet(subtype="efficientnet_b0")
    variables = init_tree(jm, jnp.asarray(x), seed=1)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(EfficientNet("efficientnet_b0"), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert tm.channels == [16, 24, 40, 80, 112, 192, 320]
    assert tm.stage2_block0.se.fc1.out_channels == 4
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-5)


@pytest.mark.parametrize("subtype", ["efficientnet_b1", "efficientnet_lite0"])
def test_efficientnet_sizes_and_classifier_match_jax(subtype):
    """The classifier form (head conv, pooling, fc) in eval mode, and as many
    parameters and BN statistics as the JAX model."""
    x = images(32)
    jm = jax_effnet.EfficientNet(subtype=subtype, classifier=True, num_classes=7)
    variables = init_tree(jm, jnp.asarray(x), seed=2)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(EfficientNet(subtype, classifier=True, num_classes=7), variables)
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    assert_close_to_scale(got.numpy(), want, 1e-5)


def test_drop_path_rates_and_whole_samples():
    """Block b of B0's 16 drops at 0.2·b/16 (JAX's rates; only residual
    blocks hold one); in train mode a block's branch is either kept whole,
    scaled by 1/(1 − rate), or zeroed, sample by sample."""
    tm = EfficientNet("efficientnet_b0")
    rates = {}
    for b, (_, name) in enumerate(tm.blocks):
        block = getattr(tm, name)
        if block.residual:
            rates[b] = block.drop.rate
        else:
            assert not hasattr(block, "drop")
    assert rates == {b: 0.2 * b / 16 for b in rates} and len(rates) == 9
    drop = DropPath(0.5).train()
    torch.manual_seed(0)
    x = torch.rand(64, 3, 4, 4) + 0.1
    y = drop(x)
    kept = (y == x * 2).flatten(1).all(1)
    dropped = (y == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 10 < int(kept.sum()) < 54
    assert torch.equal(drop.eval()(x), x)


def test_efficientnet_train_mode_and_grads_match_jax():
    """B0 at 64² in train mode, float64: C3–C5 within 1e-9 of their largest
    value and every gradient leaf of Σ features · w (w fixed, seeded)
    within 1e-6 of its largest value."""
    x = images(64)
    jm = jax_effnet.EfficientNet(subtype="efficientnet_b0")
    variables = as64(init_tree(jm, jnp.asarray(x), seed=6))
    ws = [np.random.RandomState(i).randn(B, s, s, c) for i, (s, c) in
          enumerate(((8, 40), (4, 112), (2, 320)))]

    def objective(p, a):
        feats, _ = jm.apply({**variables, "params": p}, a, True, mutable=["batch_stats"])
        return sum((f * w).sum() for f, w in zip(feats, ws)), feats

    with jax.enable_x64(True):
        (_, want), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            variables["params"], jnp.asarray(x, jnp.float64))
        want = [np.asarray(w) for w in want]
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = no_drop(load_jax_variables(EfficientNet("efficientnet_b0"), variables)).double()
    feats = tm.train()(nchw(x).double())
    sum((f * nchw(w)).sum() for f, w in zip(feats, ws)).backward()
    for g, w in zip(feats, want):
        assert_close_to_scale(nhwc(g.detach()), w, 1e-9)
    owners, state = dict(tm.named_modules()), tm.state_dict()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        name = port_name("params", path, grads)
        pairs.append((_convert(name, g, state[name], owners.get(".".join(path[:-1]))),
                      grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, g in pairs)
    assert max(float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax))
               for j, g in pairs) <= 1e-6
