"""The port's ObjectBox (its loss's cross-grid targets, SDIoU and decode)
and YOLOP (the BottleneckCSP seg decoders, the loss with and without
``drivable``/``lane`` targets, the argmax maps) against the JAX package
on the CPU, with one set of weights carried across by
``load_jax_variables``; FastestDet (in JAX's ``yolop.py`` too) in
``test_torch_fastestdet.py``.

Tolerances: ObjectBox's targets equal (float32 and float64) and its loss
terms within 1e-9 relative (float64); the models' raw outputs within 1e-4 of their largest value (float32, eval
mode); train-mode losses 1e-9 and every gradient leaf 1e-6 of its
largest value (float64); val losses and predictions as
``test_torch_yolox.py``, YOLOP's argmax maps equal (float64).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import objectbox as jax_objectbox
from cvpytorch_tpu.models import yolop as jax_yolop
from cvpytorch_tpu.models.losses import objectbox_loss as jax_ob_loss
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import objectbox, yolop
from cvpytorch_tpu_torch.models.losses import objectbox_loss
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, as64, check_train_losses_and_grads,
                                    check_val_and_infer, images, make_pair, targets,
                                    torch_targets, trains_validates_and_serves)

C = len(DICTIONARY)
HW = 64


# -- ObjectBox ----------------------------------------------------------------------------
def border_boxes():
    """Normalised cxcywh gts whose centres sit near the 8×8 grid's cell
    borders (x·8 at 3.4999, 3.5, 3.5001, 4.0, 0.3, 1.0001, 7.9) and sides:
    the floor-mod side tests flip there, and ⌊gxy − offset⌋ goes below 0
    and past the last cell (the distances use it unclamped)."""
    g = np.array([3.4999, 3.5, 3.5001, 4.0, 0.3, 1.0001, 7.9, 6.5])
    cx, cy = g / 8, g[::-1] / 8
    wh = np.full(8, 0.2)
    boxes = np.stack([cx, cy, wh, wh], -1)[None].repeat(B, 0)
    valid = np.ones((B, 8), bool)
    valid[1, 5:] = False
    return boxes, valid


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_objectbox_targets_near_cell_borders_match_jax(dtype):
    boxes, valid = border_boxes()
    with jax.enable_x64(dtype == np.float64):
        want = jax.jit(jax_ob_loss._build_level_targets, static_argnums=(2, 3))(
            jnp.asarray(boxes.astype(dtype)), jnp.asarray(valid), 8, 8)
        want = {k: np.asarray(v) for k, v in want.items()}
    got = objectbox_loss._build_level_targets(torch.from_numpy(boxes.astype(dtype)),
                                              torch.from_numpy(valid), 8, 8)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    w = got["w"].numpy().reshape(B, 8, 9)
    assert w[0, 0, 1] != w[0, 2, 1] and w[0, 4].sum() < 9
    # gt 4 (x·8 = 0.3), offset +½ in x: ⌊−0.2⌋ = −1 unclamped, so dx1 = 0.5, not 1.5
    np.testing.assert_allclose(float(got["tdist"][0, 4 * 9 + 1, 0]), 0.5, rtol=1e-6)


def raw_outs(seed, sizes=((8, 8), (4, 4), (2, 2))):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, w, 1, 5 + C) for h, w in sizes]


@pytest.mark.parametrize("seed", [0, 1])
def test_objectbox_loss_and_decode_match_jax(seed):
    """Float64 loss on random raw maps (the border gts among the random
    ones), and the decode in float32."""
    outs = raw_outs(seed)
    boxes, valid = border_boxes()
    labels = np.random.RandomState(seed).randint(0, C, (B, 8)).astype(np.int32)
    t = {"boxes": boxes, "labels": labels, "valid": valid}
    strides = (8.0, 16.0, 32.0)
    with jax.enable_x64(True):
        _, want = jax.jit(lambda o, tt: jax_ob_loss.ObjectBoxLoss(C, strides)(o, tt))(
            [jnp.asarray(o) for o in outs], {k: jnp.asarray(v) for k, v in t.items()})
        want = {k: float(v) for k, v in want.items()}
    _, got = objectbox_loss.ObjectBoxLoss(C, strides)([torch.from_numpy(o) for o in outs],
                                                      torch_targets(t))
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)
    o32 = [o.astype(np.float32) for o in outs]
    want = jax.jit(lambda o: jax_ob_loss.decode_objectbox(o, strides))(
        [jnp.asarray(o) for o in o32])
    got = objectbox_loss.decode_objectbox([torch.from_numpy(o) for o in o32], strides)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)


# -- the models ---------------------------------------------------------------------------
def seg_targets(t, hw, seed=4):
    r = np.random.RandomState(seed)
    lab = r.randint(0, 2, (2, B, hw, hw)).astype(np.int32)
    lab[:, :, :3] = 255  # ignored rows
    return {**t, "drivable": lab[0], "lane": lab[1]}


VARIANTS = {"objectbox_n": (jax_objectbox.ObjectBox, objectbox.ObjectBox,
                            {"TYPE": "objectbox_n"}, HW),
            "yolop_n": (jax_yolop.YOLOP, yolop.YOLOP, {"TYPE": "yolop_n"}, HW)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    jax_cls, port_cls, cfg, hw = VARIANTS[request.param]
    return request.param, hw, make_pair(jax_cls, port_cls, cfg, hw, t=targets(hw))


def raw(name, model, x, jax_apply=None):
    """The raw outputs the variant's predict step reads (JAX's when
    ``jax_apply``)."""
    if jax_apply is not None:
        fwd = {"objectbox_n": lambda m, i: m._raw(i, False),
               "yolop_n": lambda m, i: m._forward(i, False)}[name]
        out = jax_apply(fwd)
        return out if isinstance(out, (list, tuple)) else [out]
    with torch.no_grad():
        out = model._forward(x) if name == "yolop_n" else model._raw(x)
    if name == "yolop_n":  # the logits NCHW → NHWC
        out = [*out[0], out[1].permute(0, 2, 3, 1), out[2].permute(0, 2, 3, 1)]
    return out if isinstance(out, (list, tuple)) else [out]


def test_raw_outputs_match_jax(pair):
    name, hw, (jm, variables, tm) = pair
    x = images(hw)
    want = raw(name, None, None, lambda fwd: jax.jit(lambda v, a: jm.apply(v, a, method=fwd))(
        variables, jnp.asarray(x)))
    if name == "yolop_n":
        want = [*want[0], want[1], want[2]]
    got = raw(name, tm, torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close_to_scale(g.numpy(), np.asarray(w))


LOSS_NAMES = {"objectbox_n": ("box_loss", "obj_loss", "cls_loss"),
              "yolop_n": ("box_loss", "obj_loss", "cls_loss", "da_loss", "ll_loss")}


def test_train_loss_and_grads_match_jax(pair):
    """YOLOP with ``drivable`` and ``lane`` targets (its decoders'
    gradients), then with COCO's targets, which carry neither: the same
    detection terms (JAX's branch differs only by the seg terms it adds),
    no seg terms, the total their sum; the decoders still run and their BN
    statistics move."""
    name, hw, (jm, variables, tm) = pair
    t = seg_targets(targets(hw), hw) if name == "yolop_n" else targets(hw)
    check_train_losses_and_grads(jm, variables, tm, images(hw), t, LOSS_NAMES[name])
    if name == "yolop_n":
        x = torch.from_numpy(images(hw)).double()
        t64 = {k: v.double() if v.is_floating_point() else v for k, v in torch_targets(
            seg_targets(targets(hw), hw)).items()}
        with_seg = copy.deepcopy(tm).double().train()(x, t64, mode="train")[1]
        trained = copy.deepcopy(tm).double().train()
        total, det_only = trained(x, {k: t64[k] for k in ("boxes", "labels", "valid")},
                                  mode="train")
        assert set(det_only) == {"box_loss", "obj_loss", "cls_loss", "loss"}
        for k in ("box_loss", "obj_loss", "cls_loss"):
            assert float(det_only[k]) == float(with_seg[k]), k
        assert float(total) == float(det_only["loss"])
        np.testing.assert_allclose(float(with_seg["loss"]) - float(with_seg["da_loss"])
                                   - float(with_seg["ll_loss"]), float(total), rtol=1e-12)
        assert not torch.equal(trained.da_decoder.csp1.bn.running_mean,
                               tm.da_decoder.csp1.bn.running_mean.double())


# val images a seed whose detections hold no scores equal in float32 and
# apart in float64 (ROADMAP "Near-equal scores": YOLOP's seed 1 holds one
# such pair, which the port's float32 NMS and JAX's float64 one order
# apart)
VAL_SEED = {"objectbox_n": 1, "yolop_n": 2}


def test_val_and_infer_predictions_match_jax(pair):
    name, hw, (jm, variables, tm) = pair
    x = images(hw, seed=VAL_SEED[name])
    check_val_and_infer(jm, variables, tm, x, targets(hw))
    if name == "yolop_n":  # the argmax maps, float64 on both sides
        with jax.enable_x64(True):
            want = jax.jit(lambda v, a: jm.apply(v, a))(as64(variables),
                                                        jnp.asarray(x, jnp.float64))
        with torch.no_grad():
            got = copy.deepcopy(tm).double()(torch.from_numpy(x).double())
        for k in ("drivable", "lane"):
            assert got[k].shape == (B, hw, hw)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name,cls,size", [("coco_objectbox", objectbox.ObjectBox, 64),
                                           ("coco_yolop", yolop.YOLOP, 64)])
def test_config_trains_validates_and_serves(tmp_path, name, cls, size):
    cfg = CommonConfiguration.from_file(f"conf/{name}.yml")
    with torch.device("meta"):
        assert type(infer.build_model(cfg, DICTIONARY)) is cls
    trains_validates_and_serves(tmp_path, name, size=size)
