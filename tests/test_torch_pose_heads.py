"""The port's SimplePose and LitePose, and the heatmap helpers, against the
JAX package on the CPU, one set of weights carried across by
``load_jax_variables``.

SimplePose on ResNet-18 at 64² (three 4×4 stride-2 transposed
convolutions: ``ConvTranspose4x2`` against Flax's ``ConvTranspose``);
LitePose as ``tests/test_keypoint.py`` builds it (MobileNetV2 stages 2, 3,
5, 7, deconv widths 32/16/16, 5 keypoints) at 64².  Every mode: the
heatmaps (eval), the train losses and per-leaf gradients (SimplePose on
heatmap targets, LitePose on single-instance keypoints), LitePose's loss
on top-scale heatmaps (the antialiased resize to the coarser scale), and
the val and infer decodes.  Both sides refuse LitePose on the detection
collate's (B, M, K, 3) keypoints and on a side that is not a multiple of
32 (the configs' 368²).

Tolerances: eval heatmaps within 1e-4 of their largest value (float32);
losses 1e-9 relative and gradient leaves 1e-6 of their scale (float64);
decoded positions equal and confidences within 1e-9 (float64);
``render_gaussian_heatmaps``, ``decode_heatmaps`` and
``keypoints_to_instances`` within 1e-6 (float32).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import keypoint as jax_keypoint
from cvpytorch_tpu_torch.models import keypoint
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_openpose import DICTIONARY, images
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import as64, check_train_losses_and_grads, torch_targets

B = 2
LITE = dict(num_keypoints=5, deconv_channels=(32, 16, 16), num_outputs=2)


def lite_keypoints(seed=1, K=5, hw=64):
    rng = np.random.RandomState(seed)
    kp = np.concatenate([rng.uniform(4, hw - 4, (B, K, 2)), rng.choice([0.0, 2.0], (B, K, 1),
                                                                       p=[0.2, 0.8])], -1)
    return {"keypoints": kp.astype(np.float32)}


def simple_targets(seed=2, K=17, hw=16):
    rng = np.random.RandomState(seed)
    return {"heatmaps": rng.rand(B, hw, hw, K).astype(np.float32),
            "valid": rng.rand(B, K) < 0.8}


def make(jax_cls, port_cls, t, seed, **kw):
    jm = jax_cls(dictionary=DICTIONARY, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(images()),
        {k: jnp.asarray(v) for k, v in t.items()}, mode="train"))
    variables = fill_tree(shapes, seed)
    return jm, variables, load_jax_variables(port_cls(dictionary=DICTIONARY, **kw), variables).eval()


@pytest.fixture(scope="module")
def simple_pair():
    return make(jax_keypoint.SimplePose, keypoint.SimplePose, simple_targets(), 5)


@pytest.fixture(scope="module")
def lite_pair():
    return make(jax_keypoint.LitePose, keypoint.LitePose, lite_keypoints(), 6, **LITE)


def jax_val64(jm, variables, x, t):
    with jax.enable_x64(True):
        t64 = {k: jnp.asarray(v, jnp.float64 if v.dtype.kind == "f" else None)
               for k, v in t.items()}
        out = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
            as64(variables), jnp.asarray(x, jnp.float64), t64)
        return jax.tree_util.tree_map(np.asarray, out)


def check_val_and_infer(jm, variables, tm, t):
    """Float64 val losses and decode, and infer's decode equal to val's."""
    x = images(seed=7)
    jl, jd = jax_val64(jm, variables, x, t)
    t64 = {k: np.asarray(v, np.float64) if v.dtype.kind == "f" else v for k, v in t.items()}
    tm = copy.deepcopy(tm).double()
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x).double(), torch_targets(t64), mode="val")
        ti = tm(torch.from_numpy(x).double(), mode="infer")
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-9, err_msg=k)
    np.testing.assert_array_equal(td[..., :2].numpy(), jd[..., :2])
    np.testing.assert_allclose(td[..., 2].numpy(), jd[..., 2], atol=1e-9, rtol=0)
    assert torch.equal(ti, td)


def test_simplepose_heatmaps_match_jax(simple_pair):
    jm, variables, tm = simple_pair
    x = images()
    want = jax.jit(lambda v, a: jm.apply(v, a, method=lambda m, b: m._heatmaps(b, False)))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.heatmaps(torch.from_numpy(x))
    assert got.shape == (B, 16, 16, 17)
    assert_close_to_scale(got, want)


def test_simplepose_train_losses_and_grads_match_jax(simple_pair):
    jm, variables, tm = simple_pair
    check_train_losses_and_grads(jm, variables, tm, images(), simple_targets(),
                                 ("heatmap_loss",))


def test_simplepose_val_and_infer_match_jax(simple_pair):
    check_val_and_infer(*simple_pair, simple_targets(seed=8))


def test_litepose_pyramid_matches_jax(lite_pair):
    jm, variables, tm = lite_pair
    x = images()
    want = jax.jit(lambda v, a: jm.apply(v, a, method=lambda m, b: m._heatmap_pyramid(b, False)))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.heatmap_pyramid(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(B, 8, 8, 5), (B, 16, 16, 5)]
    for g, w in zip(got, want):
        assert_close_to_scale(g, w)


def test_litepose_train_losses_and_grads_match_jax(lite_pair):
    jm, variables, tm = lite_pair
    check_train_losses_and_grads(jm, variables, tm, images(), lite_keypoints(),
                                 ("heatmap_loss",))


def test_litepose_heatmap_target_loss_matches_jax(lite_pair):
    """Targets at the top scale (16²), resized with antialiasing to 8²."""
    jm, variables, tm = lite_pair
    t = {"heatmaps": np.random.RandomState(9).rand(B, 16, 16, 5).astype(np.float32)}
    check_train_losses_and_grads(jm, variables, tm, images(), t, ("heatmap_loss",), grads=False)


def test_litepose_val_and_infer_match_jax(lite_pair):
    check_val_and_infer(*lite_pair, lite_keypoints(seed=3))


def test_litepose_refuses_collated_keypoints_as_jax_does(lite_pair):
    """The detection collate's (B, M, 17, 3) keypoints: JAX fails to
    broadcast them against the heatmaps; the port says why."""
    jm, variables, tm = lite_pair
    kp = np.zeros((B, 3, 5, 3), np.float32)
    kp[..., :2], kp[..., 2] = 20.0, 2.0
    t = {"keypoints": kp, "valid": np.ones((B, 3), bool)}
    with pytest.raises((TypeError, ValueError), match="[Ii]ncompatible shapes for broadcasting"):
        jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="train", mutable=["batch_stats"]))(
            variables, jnp.asarray(images()), {k: jnp.asarray(v) for k, v in t.items()})
    with pytest.raises(ValueError, match=r"single-instance keypoints .*\(B, M, K, 3\)"):
        tm.train()(torch.from_numpy(images()), torch_targets(t), mode="train")


def test_litepose_refuses_sides_off_32_as_jax_does(lite_pair):
    """72² (368² in the configs): the stride-32 map's ×2 deconvolution
    (6²) does not fuse with the stride-16 one (5²), on either side."""
    jm, variables, tm = lite_pair
    x = np.zeros((1, 72, 72, 3), np.float32)
    with pytest.raises((TypeError, ValueError), match="[Ii]ncompatible shapes for broadcasting"):
        jax.jit(lambda v, a: jm.apply(v, a, mode="infer"))(variables, jnp.asarray(x))
    with pytest.raises(ValueError, match=r"multiple of 32, not \(72, 72\)"):
        tm.eval()(torch.from_numpy(x), mode="infer")


def test_heatmap_helpers_match_jax():
    rng = np.random.RandomState(4)
    kp = rng.uniform(0, 16, (B, 7, 2)).astype(np.float32)
    valid = rng.rand(B, 7) < 0.7
    want = jax_keypoint.render_gaussian_heatmaps(jnp.asarray(kp), jnp.asarray(valid), (12, 16))
    got = keypoint.render_gaussian_heatmaps(torch.from_numpy(kp), torch.from_numpy(valid), (12, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    hm = np.round(rng.rand(B, 12, 16, 7) * 4).astype(np.float32)  # ties: the first maximum
    dec = keypoint.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jax_keypoint.decode_heatmaps(
        jnp.asarray(hm))))
    dec = dec * torch.tensor([1.0, 1.0, 0.1])
    t = {"pads": np.array([[2.0, 3.0], [0.0, 0.0]], np.float32),
         "scales": np.array([[0.5, 0.5], [1.0, 1.0]], np.float32)}
    want = jax_keypoint.keypoints_to_instances(jnp.asarray(dec.numpy()), (48, 64), (12, 16),
                                               {k: jnp.asarray(v) for k, v in t.items()})
    got = keypoint.keypoints_to_instances(dec, (48, 64), (12, 16),
                                          {k: torch.from_numpy(v) for k, v in t.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


def test_resize_linear_float64_matches_jax():
    """``seg_heads.resize_linear`` in float64 takes JAX's float64 weights
    (they were rounded through float32 before: 2.6e-9 relative off
    LitePose's float64 loss)."""
    from cvpytorch_tpu_torch.models.heads.seg_heads import resize_linear

    x = np.random.RandomState(5).rand(2, 3, 16, 12)
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 8, 5), "linear"))
    got = resize_linear(torch.from_numpy(x), (8, 5)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-15, rtol=0)
