"""The port's NAS-FPN (its merging cells and half-pixel nearest resizes),
RFP (the ASPP, ResNet's ``rfp_feats`` hook, the auto-named second
backbone and the fusion gates) and the SSD prior boxes against the JAX
package on the CPU, with one set of weights carried across by
``load_jax_variables``.

Tolerances: the outputs within 1e-5 of their largest value (float32, eval
mode); train mode 1e-9 and every gradient leaf of Σ outputs · w (w fixed,
seeded) within 1e-6 of its largest value (float64); the prior boxes equal.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.anchors import prior_box as jax_prior_box
from cvpytorch_tpu.models.backbones import resnet as jax_resnet
from cvpytorch_tpu.models.necks import nas_fpn as jax_nas_fpn
from cvpytorch_tpu.models.necks import rfp as jax_rfp
from cvpytorch_tpu_torch.models.anchors import PriorBox, ssd_prior_boxes
from cvpytorch_tpu_torch.models.backbones.resnet import ResNet
from cvpytorch_tpu_torch.models.necks.nas_fpn import NASFPN, to_size
from cvpytorch_tpu_torch.models.necks.rfp import RFP
from cvpytorch_tpu_torch.registry import NECKS
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_gflv2_detectors import assert_grads_match
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import B, as64

R18 = {"name": "ResNet", "subtype": "resnet18"}


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def check_neck(jm, tm, feats, variables):
    """Eval mode in float32; then train mode in float64 with the gradient
    of Σ outputs · w."""
    jf = tuple(jnp.asarray(f) for f in feats)
    want = jax.jit(jm.apply)(variables, jf)
    with torch.no_grad():
        got = tm.eval()(tuple(nchw(f) for f in feats))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-5)
    v64 = as64(variables)
    ws = [np.random.RandomState(i).randn(*np.shape(w)) for i, w in enumerate(want)]

    def objective(p, fs):
        outs, _ = jm.apply({**v64, "params": p}, fs, True, mutable=["batch_stats"])
        return sum((o * w).sum() for o, w in zip(outs, ws)), outs

    with jax.enable_x64(True):
        (_, want), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            v64["params"], tuple(jnp.asarray(f, jnp.float64) for f in feats))
        want = [np.asarray(w) for w in want]
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = copy.deepcopy(tm).double().train()
    got = tm(tuple(nchw(f).double() for f in feats))
    sum((o * nchw(w)).sum() for o, w in zip(got, ws)).backward()
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-9)
    assert_grads_match(jgrads, tm)


# -- NAS-FPN ------------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [((13, 10), (4, 3)), ((4, 3), (13, 10)), ((7, 5), (2, 2)),
                                     ((2, 2), (7, 5)), ((8, 8), (2, 2))])
def test_to_size_equals_jax(src, dst):
    """Max-pool down by the integer ratio, then (and up) JAX's nearest with
    half-pixel centres, on sizes the ratios do not divide."""
    x = np.random.RandomState(0).randn(1, *src, 3).astype(np.float32)
    np.testing.assert_array_equal(nhwc(to_size(nchw(x), dst)),
                                  np.asarray(jax_nas_fpn._to_size(jnp.asarray(x), dst)))


@pytest.mark.parametrize("sizes", [((8, 8), (4, 4), (2, 2)), ((13, 10), (7, 5), (4, 3))],
                         ids=["64", "100x76"])
def test_nas_fpn_matches_jax(sizes):
    """Two stacks on C3–C5 (P6, P7 by the stride-2 ``extra`` convs); the
    registry's alias ``NAS_FPN`` names the class."""
    rng = np.random.RandomState(1)
    chs = (16, 24, 32)
    feats = [rng.randn(B, h, w, c).astype(np.float32) for (h, w), c in zip(sizes, chs)]
    jm = jax_nas_fpn.NASFPN(out_channels=16, stack_times=2)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=2)
    tm = load_jax_variables(NASFPN(chs, 16, stack_times=2), variables)
    assert NECKS.get("NAS_FPN") is NASFPN
    check_neck(jm, tm, feats, variables)


# -- RFP ----------------------------------------------------------------------------------
def rfp_inputs(seed=3, hw=128):
    """An image and ResNet-18's C3–C5 of it."""
    img = np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)
    s = hw // 8
    rng = np.random.RandomState(seed + 1)
    cs = [rng.randn(B, s // k, s // k, c).astype(np.float32)
          for k, c in ((1, 128), (2, 256), (4, 512))]
    return [img] + cs


def test_resnet_rfp_hook_is_the_identity_at_init():
    """Zero ``rfp_conv{stage}`` at init: ResNet-18 fed any ``rfp_feats``
    returns what it returns unfed; carried non-zero hooks change it as the
    JAX hook does."""
    x = rfp_inputs()[0]
    feeds = {s: torch.randn(B, 16, 128 // 2 ** (s + 1), 128 // 2 ** (s + 1)) for s in (2, 3, 4)}
    tm = ResNet("resnet18", rfp_in_channels={2: 16, 3: 16, 4: 16}).eval()
    with torch.no_grad():
        fed, plain = tm(nchw(x), rfp_feats=feeds), tm(nchw(x))
    for a, b in zip(fed, plain):
        assert torch.equal(a, b)
    jm = jax_resnet.ResNet(subtype="resnet18")
    jfeeds = {s: jnp.asarray(nhwc(f)) for s, f in feeds.items()}
    variables = init_tree(jm, jnp.asarray(x), seed=4, rfp_feats=jfeeds)
    want = jax.jit(lambda v, a, f: jm.apply(v, a, rfp_feats=f))(variables, jnp.asarray(x),
                                                                 jfeeds)
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(nchw(x), rfp_feats=feeds)
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-5)


def test_rfp_matches_jax():
    """Two steps on ResNet-18 at 128² (P7 1²): the second backbone carried as
    ``ResNet_0`` (Flax's automatic name), the shared ``rfp_aspp``, the
    gates ``rfp_weight1_{level}``; every weight non-zero."""
    feats = rfp_inputs()
    jm = jax_rfp.RFP(rfp_steps=2, rfp_backbone=R18, aspp_out_channels=16, out_channels=64)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=5)
    assert {"ResNet_0", "fpn", "rfp_aspp", "rfp_weight1_4"} <= set(variables["params"])
    tm = load_jax_variables(RFP((128, 256, 512), 2, R18, 16, out_channels=64), variables)
    assert tm.backbones == ["ResNet_0"] and tm.ResNet_0.rfp_conv2.in_channels == 64
    check_neck(jm, tm, feats, variables)


def test_rfp_is_the_fpn_when_its_second_backbone_is_the_first():
    """At init the hooks are zero and the gates ½: with the first
    backbone's weights carried into ``ResNet_0``, the fused pyramid is the
    plain FPN's."""
    img = rfp_inputs()[0]
    first = ResNet("resnet18").eval()
    tm = RFP((128, 256, 512), 2, R18, 16, out_channels=64).eval()
    tm.ResNet_0.load_state_dict(first.state_dict(), strict=False)
    with torch.no_grad():
        cs = first(nchw(img))
        got = tm((nchw(img), *cs))
        want = tm.fpn(cs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# -- the SSD prior boxes ------------------------------------------------------------------
SSD512 = dict(image_size=512, feature_maps=(64, 32, 16, 8, 4, 2, 1),
              min_sizes=(20, 51, 133, 215, 296, 378, 460),
              max_sizes=(51, 133, 215, 296, 378, 460, 542), strides=(8, 16, 32, 64, 128, 256, 512),
              aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)), clip=False)


@pytest.mark.parametrize("kwargs", [{}, SSD512], ids=["ssd300", "ssd512_unclipped"])
def test_prior_boxes_equal_jax(kwargs):
    """Row-major cells, then small / big / ratio pairs a cell."""
    want = jax_prior_box.PriorBox(**kwargs)()
    got = PriorBox(**kwargs)()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    if not kwargs:
        assert got.shape == (8732, 4) and np.array_equal(got, ssd_prior_boxes())
        np.testing.assert_allclose(got[:4, :2], [[0.5 / 37.5] * 2] * 4)
