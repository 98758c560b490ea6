"""The port's EfficientDet (the zero-padded "same" max-pool, BiFPN, the
shared heads with per-level BN, the anchors, the loss and the whole D0
model at 128²) against the JAX package on the CPU, with one set of
weights carried across by ``load_jax_variables``; its EfficientNet
backbone alone in ``test_torch_efficientnet.py``.

The JAX EfficientNet draws stochastic depth in every train-mode call.
The train-mode checks therefore replace the ``DropPath`` name of
``cvpytorch_tpu.models.backbones.efficientnet`` with an identity in this
test process (``monkeypatch``; no JAX file changes) and set the port's
rates to 0.

Tolerances: the max-pool equal; BiFPN and the heads within 1e-5 / 1e-4
of their largest output (float32, eval mode), BiFPN's train mode 1e-9
(float64); anchors equal; the loss terms within 1e-9 relative (float64);
the model's train-mode losses 1e-9 and every gradient leaf 1e-6 of its
largest value (float64, on ResNet-18: XLA's float64 depthwise
convolutions are slow); val losses and predictions as
``test_torch_yolox.py``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvpytorch_tpu.models import efficientdet as jax_effdet
from cvpytorch_tpu.models.backbones import efficientnet as jax_effnet
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import efficientdet
from cvpytorch_tpu_torch.models.bricks import DropPath
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, as64, check_train_losses_and_grads,
                                    check_val_and_infer, images, make_pair, targets,
                                    trains_validates_and_serves)

HW = 128  # the smallest size whose P6 and P7 anchors match the maps (2², 1²)
C = len(DICTIONARY)


class _NoDrop(fnn.Module):
    """The JAX ``DropPath``'s interface, returning its input."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return x


@pytest.fixture(scope="module", autouse=True)
def jax_without_drop_path():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_effnet, "DropPath", _NoDrop)
        yield


def no_drop(model):
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return model


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# -- the bricks ---------------------------------------------------------------------------
@pytest.mark.parametrize("hw", [(7, 10), (8, 8), (3, 2), (1, 1)])
def test_maxpool_same_pads_with_zeros(hw):
    """Negative features: the border windows pool to 0 as in JAX (−inf
    padding would give the negative maxima)."""
    x = -np.random.RandomState(0).rand(B, *hw, 3).astype(np.float32) - 0.5
    want = np.asarray(jax_effdet._maxpool_same(jnp.asarray(x)))
    got = nhwc(efficientdet.maxpool_same(nchw(x)))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and ((got < 0).any() or min(hw) < 4)


def test_bifpn_at_96_matches_jax():
    """Three cells at 96², where P5 is 3² and P6 2²: the upsamples are not
    ×2 (2 → 3, 1 → 2); eval mode in float32, train mode and the running
    statistics in float64; the fusion weights (bare params) carried."""
    rng = np.random.RandomState(3)
    chs = (40, 112, 320)
    feats = [rng.randn(B, s, s, c).astype(np.float32) for s, c in zip((12, 6, 3), chs)]
    jm = jax_effdet.BiFPN(channels=32, repeats=3)
    jf = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jf, seed=4)
    variables["params"]["cell1"]["p5_w2"] = np.array([0.5, -1.0, 2.0], np.float32)
    tm = load_jax_variables(efficientdet.BiFPN(chs, 32, 3), variables).eval()
    want = jax.jit(jm.apply)(variables, jf)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert [g.shape[-1] for g in got] == [12, 6, 3, 2, 1]
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-5)
    v64 = as64(variables)
    with jax.enable_x64(True):
        want, new = jax.jit(lambda v, f: jm.apply(v, f, True, mutable=["batch_stats"]))(
            v64, tuple(jnp.asarray(f, jnp.float64) for f in feats))
        want = [np.asarray(w) for w in want]
        new = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    trained = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        got = trained([nchw(f).double() for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-9)
    stats = load_jax_variables(copy.deepcopy(tm).double(), {**v64, "batch_stats": new})
    for k, v in trained.state_dict().items():
        if "running" in k:
            assert_close_to_scale(v.numpy(), stats.state_dict()[k].numpy(), 1e-9)


# -- anchors and loss ---------------------------------------------------------------------
@pytest.mark.parametrize("hw,scale", [((512, 512), 4.0), ((128, 96), 4.0), ((640, 640), 5.0)])
def test_anchors_equal_jax(hw, scale):
    got = efficientdet.efficientdet_anchors(hw, anchor_scale=scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_effdet.efficientdet_anchors(
        hw, anchor_scale=scale)))
    if hw == (512, 512):
        assert got.shape == (49104, 4) and got.dtype == np.float32


def loss_inputs(seed):
    """Probabilities and regressions over 128²'s anchors, gts of which some
    overlap anchors at IoU ≥ .5 and some sit in the ignored band; image 1
    holds padding only."""
    anchors = np.asarray(jax_effdet.efficientdet_anchors((HW, HW)))
    P = anchors.shape[0]
    rng = np.random.RandomState(seed)
    cls = 1 / (1 + np.exp(-rng.randn(B, P, C) * 3))
    reg = rng.randn(B, P, 4) * 0.3
    t = targets(HW, seed)
    t["boxes"][0, 0] = anchors[100][[1, 0, 3, 2]]  # an anchor itself (IoU 1)
    t["valid"][1] = False
    return cls, reg, anchors, t


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_matches_jax_float64(seed):
    """Float64 on both sides; image 1 is all padding (every anchor
    negative, its reg term 0)."""
    cls, reg, anchors, t = loss_inputs(seed)
    t["boxes"] = t["boxes"].astype(np.float64)
    with jax.enable_x64(True):
        jt = {k: jnp.asarray(v) for k, v in t.items()}
        want = jax.jit(jax_effdet.efficientdet_loss)(jnp.asarray(cls), jnp.asarray(reg),
                                                      jnp.asarray(anchors), jt)
        want = [float(w) for w in want]
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
    got = efficientdet.efficientdet_loss(torch.from_numpy(cls), torch.from_numpy(reg),
                                         torch.from_numpy(anchors), tt)
    np.testing.assert_allclose([float(g) for g in got], want, rtol=1e-9)
    iou, _ = efficientdet.effdet_targets(torch.from_numpy(anchors), tt["boxes"], tt["valid"])
    assert (iou[0] >= 0.5).sum() > 0 and ((iou[0] >= 0.4) & (iou[0] < 0.5)).sum() > 0
    assert bool((iou[1] == -1).all())


# -- the model ----------------------------------------------------------------------------
# XLA runs float64 depthwise convolutions slowly on the CPU (B0's train step
# at 128² takes it ~50 s): the float64 checks of the whole model run it on
# ResNet-18 (a ``BACKBONE`` the model takes), EfficientNet's float64 train
# mode is held alone (``test_torch_efficientnet.py``), and the config's B0
# model in float32.
R18 = {"name": "ResNet", "subtype": "resnet18", "out_stages": [2, 3, 4]}


@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_effdet.EfficientDet, efficientdet.EfficientDet,
                     {"TYPE": "efficientnet_b0"}, HW)


@pytest.fixture(scope="module")
def pair_r18():
    return make_pair(jax_effdet.EfficientDet, efficientdet.EfficientDet,
                     {"TYPE": "efficientnet_b0", "BACKBONE": R18}, HW)


def test_head_outputs_match_jax(pair):
    jm, variables, tm = pair
    x = images(HW)
    jc, jr, ja = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._forward(
        i, tr)))(variables, jnp.asarray(x))
    with torch.no_grad():
        tc, tr, ta = tm._forward(torch.from_numpy(x))
    assert tc.shape == (B, 3069, C) and tr.shape == (B, 3069, 4)
    assert len(tm.fpn.cell0.p6_w1) == 2 and hasattr(tm.classifier, "bn4_2")
    assert_close_to_scale(tc.numpy(), jc)
    assert_close_to_scale(tr.numpy(), jr)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_train_loss_and_grads_match_jax(pair_r18):
    jm, variables, tm = pair_r18
    check_train_losses_and_grads(jm, variables, tm, images(HW), targets(HW),
                                 ("cls_loss", "box_loss"))


def test_val_and_infer_predictions_match_jax(pair_r18):
    jm, variables, tm = pair_r18
    check_val_and_infer(jm, variables, tm, images(HW, seed=1), targets(HW))


@pytest.mark.parametrize("type_", ["efficientnet_b1"])
def test_sizes_build_the_jax_model(type_):
    """D1 (D0's tree is carried whole by ``make_pair``): as many parameters
    and BN statistics as the JAX model."""
    kw = dict(dictionary=DICTIONARY, model_cfg={"TYPE": type_})
    shapes = jax.eval_shape(lambda: jax_effdet.EfficientDet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = efficientdet.EfficientDet(**kw)
    got = sum(v.numel() for k, v in m.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == want


def test_config_trains_validates_and_serves(tmp_path):
    """``conf/coco_efficientdet.yml`` (``TYPE: efficientnet_b0`` → D0)
    through ``Trainer.run()`` and ``infer.main`` at 128²."""
    cfg = CommonConfiguration.from_file("conf/coco_efficientdet.yml")
    with torch.device("meta"):
        built = infer.build_model(cfg, DICTIONARY)
    assert type(built) is efficientdet.EfficientDet and built.fpn.repeats == 3
    trains_validates_and_serves(tmp_path, "coco_efficientdet", size=HW)
