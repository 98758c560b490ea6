"""The port's segmentation losses against the JAX package on the CPU,
float32: each of the seven at one point, with ignored pixels and class
weights, its value within 1e-5 relative and its gradient with respect to
the logits within 1e-5 of the largest gradient.  The JAX functions take
NHWC logits, the port's NCHW."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.losses import seg_loss as jax_seg_loss
from cvpytorch_tpu_torch.models.losses import seg_loss
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

B, C, H, W = 2, 5, 12, 16
WEIGHTS = [1.0, 0.5, 2.0, 1.5, 0.8]

CASES = [
    ("CrossEntropyLoss2d", {"class_weights": WEIGHTS}),
    ("CrossEntropyLoss2d", {"label_smoothing": 0.1}),
    ("OhemCrossEntropyLoss2d", {"class_weights": WEIGHTS}),
    ("OhemCrossEntropyLoss2d", {"thresh": 0.1, "min_kept_ratio": 0.5}),
    ("BCEWithLogitsLoss2d", {}),
    ("DiceLoss", {"smooth": 0.5}),
    ("FocalLoss2d", {"class_weights": WEIGHTS, "gamma": 1.5}),
    ("LovaszSoftmax", {}),
    ("CrossEntropyDiceLoss", {"class_weights": WEIGHTS, "dice_weight": 0.5}),
]


def inputs(name, seed=0):
    """Logits of spread ±3 and labels with a band of ignored pixels (the
    binary loss takes one channel and labels in {0, 1})."""
    rng = np.random.RandomState(seed)
    c = 1 if name == "BCEWithLogitsLoss2d" else C
    logits = (rng.randn(B, c, H, W) * 3).astype(np.float32)
    labels = rng.randint(0, 2 if c == 1 else C, (B, H, W)).astype(np.int32)
    labels[0, :3] = 255
    labels[1, :, -2:] = 255
    return logits, labels


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_loss_and_grad_match_jax(name, kwargs):
    logits, labels = inputs(name)
    kw_jax = {k: (jnp.asarray(v) if k == "class_weights" else v) for k, v in kwargs.items()}
    jfn = jax_seg_loss.SEG_LOSSES[name]
    want, jgrad = jax.value_and_grad(
        lambda x: jfn(x, jnp.asarray(labels), **kw_jax))(jnp.asarray(logits.transpose(0, 2, 3, 1)))
    x = torch.from_numpy(logits).requires_grad_()
    got = seg_loss.SEG_LOSSES[name](x, torch.from_numpy(labels), **kwargs)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jgrad = np.asarray(jgrad).transpose(0, 3, 1, 2)
    scale = np.abs(jgrad).max()
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy(), jgrad, atol=1e-5 * scale, rtol=0)


def test_build_seg_loss_binds_the_config_keys():
    logits, labels = inputs("FocalLoss2d", seed=1)
    fn = seg_loss.build_seg_loss("FocalLoss2d", gamma=1.0, alpha=0.5)
    want = jax_seg_loss.build_seg_loss("FocalLoss2d", gamma=1.0, alpha=0.5)(
        jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(labels))
    got = fn(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert seg_loss.build_seg_loss("DiceLoss") is seg_loss.dice_loss


def test_all_pixels_ignored_gives_zero_not_nan():
    logits, labels = inputs("CrossEntropyLoss2d")
    labels[:] = 255
    for name in ("CrossEntropyLoss2d", "OhemCrossEntropyLoss2d", "FocalLoss2d",
                 "LovaszSoftmax"):
        got = seg_loss.SEG_LOSSES[name](torch.from_numpy(logits), torch.from_numpy(labels))
        assert float(got) == 0.0, name
