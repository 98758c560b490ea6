"""The port's classification models and losses against the JAX package on
the CPU, with one set of weights carried across by ``load_jax_variables``.

Tolerances: eval-mode outputs within 1e-5 of their largest value; losses
within 1e-5 relative; per-leaf gradients within 5e-3 of the leaf's
largest value, in float64 on both sides (as the other model tests hold
them), with the classifier's dropout at 0: JAX draws its dropout mask
from its own RNG, which no torch draw can match.  Eval mode keeps the
config's dropout of 0.2, which eval mode does not apply.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones.mobilenetv2 import MobileNetV2 as JaxMobileNetV2
from cvpytorch_tpu.models.classification import Classification as JaxClassification
from cvpytorch_tpu.models.losses import cls_loss as jax_cls_loss
from cvpytorch_tpu_torch.models.backbones.mobilenetv2 import MobileNetV2
from cvpytorch_tpu_torch.models.classification import Classification
from cvpytorch_tpu_torch.models.losses import cls_loss
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree, init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = ({"a": 1.0}, {"b": 2.0}, {"c": 0.5}, {"d": 1.0}, {"e": 1.5})
B = 4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close_to_scale(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def images(hw, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def labels(seed=1):
    return np.random.RandomState(seed).randint(0, len(DICTIONARY), B).astype(np.int32)


@pytest.mark.parametrize("classifier", [True, False])
def test_mobilenetv2_matches_jax(classifier):
    """Width 0.35 at 32², eval mode: the logits, or the features of block
    groups 3, 5 and 7."""
    x = images(32)
    kw = dict(width_mult=0.35, classifier=classifier, num_classes=7)
    jm = JaxMobileNetV2(**kw)
    variables = init_tree(jm, jnp.asarray(x), seed=3)
    tm = load_jax_variables(MobileNetV2(**kw), variables).eval()
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    if classifier:
        assert_close_to_scale(got.numpy(), want)
        return
    assert len(got) == len(want) == 3
    for g, w, c in zip(got, want, (tm.channels[2], tm.channels[4], tm.channels[6])):
        assert g.shape[1] == c
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)


BACKBONES = {
    "resnet18": {"name": "ResNet", "subtype": "resnet18"},
    "mobilenetv2": {"name": "MobileNetV2", "width_mult": 0.35},
}


def make_pair(backbone, dropout=0.2, label_smoothing=0.1, hw=64):
    cfg = {"BACKBONE": {**BACKBONES[backbone], "dropout": dropout}}
    jm = JaxClassification(dictionary=DICTIONARY, model_cfg=cfg,
                           label_smoothing=label_smoothing)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(images(hw)),
                                            jnp.asarray(labels()), mode="val"))
    variables = fill_tree(shapes, 4)
    tm = load_jax_variables(Classification(dictionary=DICTIONARY, model_cfg=cfg,
                                           label_smoothing=label_smoothing), variables)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_val_and_infer_match_jax(backbone):
    """Eval mode with dropout 0.2: the class-weighted, smoothed val loss
    within 1e-5 relative, the val and infer argmax equal."""
    jm, variables, tm = make_pair(backbone)
    x, y = images(64, seed=2), labels(seed=3)
    jl, jpred = jm.apply(variables, jnp.asarray(x), jnp.asarray(y), mode="val")
    jinfer = jm.apply(variables, jnp.asarray(x), mode="infer")
    with torch.no_grad():
        tl, tpred = tm(torch.from_numpy(x), torch.from_numpy(y), mode="val")
        tinfer = tm(torch.from_numpy(x), mode="infer")
    assert set(tl) == set(jl) == {"ce_loss"}
    np.testing.assert_allclose(float(tl["ce_loss"]), float(jl["ce_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(tinfer.numpy(), np.asarray(jinfer))
    if backbone == "mobilenetv2":
        assert tm.backbone.dropout.p == 0.2


def jax_train(jm, variables, params, x, y):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, jnp.asarray(y), mode="train", mutable=["batch_stats"])
    return total, parts


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_train_mode_loss_and_grads_match_jax(backbone):
    """Dropout 0: the train loss within 1e-5 relative in float32; per-leaf
    gradients within 5e-3, float64 on both sides."""
    jm, variables, tm = make_pair(backbone, dropout=0.0)
    x, y = images(64, seed=5), labels(seed=6)
    jtotal, jparts = jax_train(jm, variables, variables["params"], jnp.asarray(x), y)
    with torch.no_grad():
        total, parts = copy.deepcopy(tm).train()(torch.from_numpy(x), torch.from_numpy(y),
                                                 mode="train")
    assert set(parts) == set(jparts) == {"ce_loss"}
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)

    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        jgrads = jax.jit(jax.grad(
            lambda p: jax_train(jm, as64, p, jnp.asarray(x, jnp.float64), y)[0]))(as64["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = copy.deepcopy(tm).double().train()
    total, _ = tm(torch.from_numpy(x).double(), torch.from_numpy(y), mode="train")
    total.backward()
    owners = dict(tm.named_modules())
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        assert g.dtype == np.float64
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        name = ".".join(path[:-1] + (leaf,))
        pairs.append((name, _convert(name, g, tm.state_dict()[name],
                                     owners[".".join(path[:-1])]), grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= 5e-3, worst


def test_default_backbone_is_a_resnet18_classifier():
    tm = Classification(dictionary=DICTIONARY)
    assert type(tm.backbone).__name__ == "ResNet" and tm.backbone.fc.out_features == 5


# -- losses -------------------------------------------------------------------------
def loss_inputs(seed=0, N=12, C=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, C) * 2).astype(np.float32), rng.randint(0, C, N).astype(np.int32)


@pytest.mark.parametrize("weights,smoothing", [(None, 0.0), ([1, 2, 0.5, 1, 3], 0.0),
                                               (None, 0.1), ([1, 2, 0.5, 1, 3], 0.2)])
def test_cross_entropy_matches_jax(weights, smoothing):
    logits, y = loss_inputs()
    want = jax_cls_loss.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(y), weights,
                                           smoothing)
    got = cls_loss.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(y), weights,
                                      smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("alpha,weights", [(0.25, None), (None, [1, 2, 0.5, 1, 3])])
def test_focal_loss_matches_jax(alpha, weights):
    logits, y = loss_inputs(1)
    want = jax_cls_loss.focal_loss(jnp.asarray(logits), jnp.asarray(y), gamma=2.0, alpha=alpha,
                                   class_weights=weights)
    got = cls_loss.focal_loss(torch.from_numpy(logits), torch.from_numpy(y), gamma=2.0,
                              alpha=alpha, class_weights=weights)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("loss_type", ["focal", "sigmoid", "softmax"])
def test_class_balanced_loss_matches_jax(loss_type):
    logits, y = loss_inputs(2)
    spc = [100, 20, 5, 300, 1]
    want = jax_cls_loss.class_balanced_loss(jnp.asarray(logits), jnp.asarray(y), spc,
                                            beta=0.999, loss_type=loss_type)
    got = cls_loss.class_balanced_loss(torch.from_numpy(logits), torch.from_numpy(y), spc,
                                       beta=0.999, loss_type=loss_type)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError):
        cls_loss.class_balanced_loss(torch.from_numpy(logits), torch.from_numpy(y), spc,
                                     loss_type="hinge")
