"""The port's VGG backbone and OpenPose against the JAX package on the CPU,
one set of weights carried across by ``load_jax_variables``.

VGG: ``vgg16_bn`` and ``vgg11`` at 32² (eval mode, every captured stage)
and the classifier's ``_adaptive_avg_pool``.  OpenPose as
``tests/test_paf.py`` builds it (ResNet-18 to stage 2, 2 stages) at 64²,
on three skeletons an image (one padded row): the infer maps, the train
losses with per-leaf gradients (targets rendered in the graph from the
(B, M, 17, 3) keypoints), and the val losses with the in-graph decode
(peaks, scores, ``conns``).

Tolerances: eval-mode outputs within 1e-4 of their largest value
(float32); train losses within 1e-9 relative and every gradient leaf
within 1e-6 of its scale (float64); val losses 1e-9 relative, the peaks'
validity and ``conns``' slots equal, peak scores and positions and the
match scores within 1e-9 (float64).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import keypoint as jax_keypoint
from cvpytorch_tpu.models.backbones import vgg as jax_vgg
from cvpytorch_tpu_torch.models import keypoint
from cvpytorch_tpu_torch.models.backbones import vgg
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_paf import skeleton
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import as64, check_train_losses_and_grads, torch_targets

DICTIONARY = ({"person": 1.0},)
B, HW = 2, 64
R18 = {"BACKBONE": {"name": "ResNet", "subtype": "resnet18", "out_stages": (2,)}}


def images(hw=HW, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def keypoint_targets(hw=HW, seed=1, M=4):
    """Three jittered skeletons an image in ``hw``² pixels, some joints
    invisible, the last row padding."""
    rng = np.random.RandomState(seed)
    kp = np.zeros((B, M, 17, 3), np.float32)
    s = hw / 184
    for b in range(B):
        for m, (cx, cy, sc) in enumerate(((60, 90, 0.6), (130, 100, 0.6), (95, 70, 0.4))):
            kp[b, m] = skeleton(cx * s, cy * s, sc * s)
            kp[b, m, :, :2] += rng.uniform(-2, 2, (17, 2))
            kp[b, m, rng.rand(17) < 0.15, 2] = rng.choice([0, 1])
    valid = np.ones((B, M), bool)
    valid[:, -1] = False
    return {"keypoints": kp, "valid": valid}


@pytest.mark.parametrize("subtype", ["vgg16_bn", "vgg11"])
def test_vgg_matches_jax(subtype):
    x = images(32)
    jm = jax_vgg.VGG(subtype=subtype, out_stages=(1, 2, 3, 4))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = fill_tree(shapes, 1)
    want = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    tm = load_jax_variables(vgg.VGG(subtype=subtype, out_stages=(1, 2, 3, 4)), variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    assert tm.out_channels == [128, 256, 512, 512]
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1), w)


def test_vgg_adaptive_avg_pool_matches_jax():
    x = np.random.RandomState(2).randn(2, 14, 21, 3).astype(np.float32)
    want = jax_vgg._adaptive_avg_pool(jnp.asarray(x), 7, 7)
    got = vgg._adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 7, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def openpose_pair():
    jm = jax_keypoint.OpenPose(dictionary=DICTIONARY, model_cfg=R18, num_stages=2)
    t = keypoint_targets()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(images()),
        {k: jnp.asarray(v) for k, v in t.items()}, mode="train"))
    variables = fill_tree(shapes, 3)
    tm = keypoint.OpenPose(dictionary=DICTIONARY, model_cfg=R18, num_stages=2)
    return jm, variables, load_jax_variables(tm, variables).eval()


def test_openpose_infer_maps_match_jax(openpose_pair):
    jm, variables, tm = openpose_pair
    x = images()
    want = jax.jit(lambda v, a: jm.apply(v, a, mode="infer"))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mode="infer")
    assert got["heatmaps"].shape == (B, 8, 8, 19) and got["pafs"].shape == (B, 8, 8, 38)
    for k in ("heatmaps", "pafs"):
        assert_close_to_scale(got[k], want[k])


def test_openpose_train_losses_and_grads_match_jax(openpose_pair):
    jm, variables, tm = openpose_pair
    check_train_losses_and_grads(jm, variables, tm, images(), keypoint_targets(),
                                 ("heatmap_loss", "paf_loss"))


def test_openpose_val_decode_matches_jax(openpose_pair):
    """Float64: the losses, and the decode pieces the evaluator takes."""
    jm, variables, tm = openpose_pair
    x = images(seed=4)
    t = {k: np.asarray(v, np.float64) if v.dtype.kind == "f" else v
         for k, v in keypoint_targets(seed=5).items()}
    with jax.enable_x64(True):
        jl, jd = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
            as64(variables), jnp.asarray(x, jnp.float64), {k: jnp.asarray(v) for k, v in t.items()})
        jl, jd = jax.tree_util.tree_map(np.asarray, (jl, jd))
    with torch.no_grad():
        tl, td = copy.deepcopy(tm).double()(torch.from_numpy(x).double(), torch_targets(t),
                                             mode="val")
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-9, err_msg=k)
    assert set(td) == set(jd)
    np.testing.assert_array_equal(td["stride"].numpy(), jd["stride"])
    np.testing.assert_array_equal(td["peaks_score"].numpy() > 0, jd["peaks_score"] > 0)
    np.testing.assert_array_equal(td["conns"][..., :2].numpy(), jd["conns"][..., :2])
    for k in ("peaks_score", "conns", "peaks_xy"):
        np.testing.assert_allclose(td[k].numpy(), jd[k], atol=1e-9, rtol=0, err_msg=k)
    assert (jd["conns"][..., 0] >= 0).sum() >= 10 and (jd["peaks_score"] > 0).sum() >= 40
