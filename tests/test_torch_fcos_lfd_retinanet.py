"""The port's FCOS (``FCOSFPN``, the FCOS head, its targets, loss and
decode), LFD (``LFDResNet``, ``LFDNeck``) and RetinaNet (its anchors,
head and loss) against the JAX package on the CPU, with one set of
weights carried across by ``load_jax_variables``; the models on
ResNet-18 (FCOS, RetinaNet) and lfd_s (the subtype both LFD configs
build) at 64² and 128²; every LFD subtype's backbone alone at 128².

Tolerances: ``gen_fcos_targets`` (the centerness targets within 1e-6)
and ``retina_anchors`` equal (float32), constructed ties of gt area
included; ``fcos_loss`` within 1e-5 relative
(float32); ``FCOSFPN`` and the LFD backbones within 1e-5 of their largest
output (float32, eval mode); the heads' outputs within 1e-4 of their
largest value (float32, eval mode); train-mode loss terms 1e-9 and
gradient leaves 1e-6 of their largest value, float64 on both sides; val
losses and the val and infer predictions through ``batched_nms`` as in
``test_torch_yolox.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import fcos as jax_fcos
from cvpytorch_tpu.models import lfd as jax_lfd
from cvpytorch_tpu.models import retinanet as jax_retinanet
from cvpytorch_tpu.models.backbones import lfd_resnet as jax_lfd_resnet
from cvpytorch_tpu.models.heads import fcos_head as jax_fcos_head
from cvpytorch_tpu.models.necks import fcos_fpn as jax_fcos_fpn
from cvpytorch_tpu_torch.models import fcos, lfd, retinanet
from cvpytorch_tpu_torch.models.backbones.lfd_resnet import FastestBlock, LFDResNet
from cvpytorch_tpu_torch.models.heads import fcos_head
from cvpytorch_tpu_torch.models.necks.fcos_fpn import FCOSFPN
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, check_train_losses_and_grads,
                                    check_val_and_infer, images, make_pair, targets,
                                    trains_validates_and_serves)

C = len(DICTIONARY)
HW = 128
# the models' checks: 64² (XLA runs float64 convolutions slowly), LFD at
# 128², where its stride-64 and 128 levels are 2×2 and 1×1 (at 64² they are
# 1×1, and BN over the batch's 2 values a channel puts JAX's own float64
# gradients 3e-6 off, its E[x²] − E[x]² variance cancelling)
MODEL_HW = {"fcos_r18": 64, "lfd_s": 128, "retinanet_r18": 64}
R18 = {"name": "ResNet", "subtype": "resnet18", "out_stages": [2, 3, 4]}


def test_fcos_fpn_matches_jax():
    """C3–C5 of a 100×76 input (13×10, 7×5, 4×3: the top-down resizes do
    not divide), P6 of P5 and of C5."""
    rng = np.random.RandomState(0)
    chs = (32, 64, 128)
    feats = [rng.randn(B, h, w, c).astype(np.float32)
             for (h, w), c in zip(((13, 10), (7, 5), (4, 3)), chs)]
    for use_p5 in (True, False):
        jm = jax_fcos_fpn.FCOSFPN(out_channels=32, use_p5=use_p5)
        variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=1)
        want = jm.apply(variables, tuple(jnp.asarray(f) for f in feats))
        tm = load_jax_variables(FCOSFPN(chs, 32, use_p5), variables)
        with torch.no_grad():
            got = tm([nchw(f) for f in feats])
        assert [g.shape[-2:] for g in got] == [(13, 10), (7, 5), (4, 3), (2, 2), (1, 1)]
        for g, w in zip(got, want):
            assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)


def fcos_gts(seed, hw=HW):
    """Targets with a tie: image 0's gt 3 has gt 1's area at another
    place overlapping it (the location takes the first by ``argmin``)."""
    t = targets(hw, seed)
    b = t["boxes"]
    b[0, 3] = b[0, 1] + np.float32(2.0)
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_gen_fcos_targets_match_jax(seed):
    t = fcos_gts(seed)
    shapes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    want = jax.jit(lambda *a: jax_fcos_head.gen_fcos_targets(shapes, *a))(
        *map(jnp.asarray, (t["boxes"], t["labels"], t["valid"])))
    got = fcos_head.gen_fcos_targets(shapes, *map(torch.from_numpy, (t["boxes"], t["labels"],
                                                                      t["valid"])))
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 1:  # the centerness: √ of a ratio, an ulp apart where XLA fuses it
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] >= 0).sum() > 20


def head_outputs(seed, shapes=((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, h, w, C).astype(np.float32) * 2, rng.randn(B, h, w, 1).astype(
        np.float32), np.exp(rng.randn(B, h, w, 4) + 3).astype(np.float32)) for h, w in shapes]


@pytest.mark.parametrize("seed", [0, 1])
def test_fcos_loss_and_decode_match_jax(seed):
    outs, t = head_outputs(seed), fcos_gts(seed + 2)
    jouts = [tuple(map(jnp.asarray, o)) for o in outs]
    jt = tuple(map(jnp.asarray, (t["boxes"], t["labels"], t["valid"])))
    jtotal, jparts = jax.jit(lambda o, b, l, v: jax_fcos_head.fcos_loss(o, b, l, v, C))(
        jouts, *jt)
    touts = [tuple(map(torch.from_numpy, o)) for o in outs]
    total, parts = fcos_head.fcos_loss(touts, *map(torch.from_numpy, (
        t["boxes"], t["labels"], t["valid"])), C)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    want = jax.jit(lambda o: jax_fcos_head.decode_fcos(o, C))(jouts)
    for g, w in zip(fcos_head.decode_fcos(touts, C), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_retina_anchors_match_jax():
    shapes = [(13, 10), (7, 5), (4, 3), (2, 2), (1, 1)]
    np.testing.assert_array_equal(retinanet.retina_anchors(shapes).numpy(),
                                  np.asarray(jax_retinanet.retina_anchors(shapes)))


@pytest.mark.parametrize("subtype", ["lfd_xs", "lfd_s", "lfd_m", "lfd_l"])
def test_lfd_backbones_match_jax(subtype):
    """Every block mode (Faster, Fast), five levels at strides 8–128."""
    x = images(HW)
    jm = jax_lfd_resnet.LFDResNet(subtype=subtype)
    variables = init_tree(jm, jnp.asarray(x), seed=5)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(LFDResNet(subtype), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert [g.shape[1] for g in got] == tm.out_channels
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)


def test_fastest_block_matches_jax():
    """The half-width block no subtype uses."""
    x = np.random.RandomState(3).randn(B, 8, 6, 16).astype(np.float32)
    jm = jax_lfd_resnet.FastestBlock(32, stride=2)
    variables = init_tree(jm, jnp.asarray(x), seed=2)
    tm = load_jax_variables(FastestBlock(16, 32, 2), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert_close_to_scale(got, jm.apply(variables, jnp.asarray(x)), 1e-6)


# -- the models --------------------------------------------------------------------------
MODELS = {
    "fcos_r18": (jax_fcos.FCOS, fcos.FCOS, {"BACKBONE": R18}),
    "lfd_s": (jax_lfd.LFD, lfd.LFD, {"TYPE": "lfd_s"}),
    "retinanet_r18": (jax_retinanet.RetinaNet, retinanet.RetinaNet, {"BACKBONE": R18}),
}
NAMES = {"fcos_r18": ("cls_loss", "cnt_loss", "reg_loss"),
         "lfd_s": ("cls_loss", "cnt_loss", "reg_loss"),
         "retinanet_r18": ("cls_loss", "reg_loss")}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    jax_cls, port_cls, cfg = MODELS[request.param]
    return (request.param, *make_pair(jax_cls, port_cls, cfg, MODEL_HW[request.param]))


def test_head_outputs_match_jax(pair):
    name, jm, variables, tm = pair
    x = images(MODEL_HW[name])
    if name.startswith("retinanet"):
        want = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._forward(
            i, tr)[:2]))(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tm._forward(torch.from_numpy(x))[:2]
        assert got[0].shape == (B, 86 * 9, C)
    else:
        want = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._outs(
            i, tr)))(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tm._outs(torch.from_numpy(x).permute(0, 3, 1, 2))
        got, want = [t for o in got for t in o], [t for o in want for t in o]
        assert len(got) == 15
    for g, w in zip(got, want):
        assert_close_to_scale(g.numpy(), w)


def test_train_loss_and_grads_match_jax(pair):
    name, jm, variables, tm = pair
    hw = MODEL_HW[name]
    check_train_losses_and_grads(jm, variables, tm, images(hw), targets(hw),
                                 NAMES[name])


def test_val_and_infer_predictions_match_jax(pair):
    name, jm, variables, tm = pair
    hw = MODEL_HW[name]
    check_val_and_infer(jm, variables, tm, images(hw, seed=1), targets(hw))


def test_the_configs_build_the_jax_models():
    """coco_fcos's ResNet-50 FCOS and the default LFD and RetinaNet: as many
    parameters and BN statistics as the JAX model (shapes only, at 64²)."""
    for jax_cls, port_cls, cfg in ((jax_fcos.FCOS, fcos.FCOS, {}), (jax_lfd.LFD, lfd.LFD, {}),
                                   (jax_retinanet.RetinaNet, retinanet.RetinaNet, {})):
        kw = dict(dictionary=DICTIONARY, model_cfg=cfg)
        shapes = jax.eval_shape(lambda: jax_cls(**kw).init(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 64, 64, 3))))
        want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        with torch.device("meta"):
            m = port_cls(**kw)
        got = sum(v.numel() for k, v in m.state_dict().items()
                  if not k.endswith("num_batches_tracked"))
        assert got == want, port_cls.__name__


@pytest.mark.parametrize("name,model", [
    ("coco_fcos", {"BACKBONE": R18}), ("widerface_faceboxes", {}),
    ("pennfudan_retinanet", {"BACKBONE": R18})])
def test_configs_train_validate_and_serve(tmp_path, name, model):
    """Each family's config at 128² (FCOS and RetinaNet on ResNet-18)."""
    state = trains_validates_and_serves(tmp_path, name, size=128, **model)
    assert type(state.model).__name__ == {"coco_fcos": "FCOS", "widerface_faceboxes": "LFD",
                                          "pennfudan_retinanet": "RetinaNet"}[name]
