"""The port's YOLOv7 (``YOLOv7Loss``: YOLOv5's candidates, the SimOTA
refinement and the level losses; RepConv; the whole model at the width
multiplier of ``yolov7_n``) against the JAX package on the CPU, with one
set of weights carried across by ``load_jax_variables``.

Tolerances: the OTA stage's selection and matched gt equal, index for
index, also where constructed ties of cost and IoU decide them (float64,
and float32 on a seed whose dynamic-k sums lie ≥ 1e-4 from an integer);
the loss terms within 1e-5 relative in float32 and 1e-9 in float64; the
train-form RepConv within 1e-6 of its largest output; the model's raw
maps within 1e-4 of their largest value (float32, eval mode); train-mode
terms 1e-9 and gradient leaves 1e-6 of their largest value, float64 on
both sides; val losses and the val and infer predictions through
``yolo_non_max_suppression`` as in ``test_torch_yolox.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import yolov7 as jax_yolov7
from cvpytorch_tpu.models.losses import yolov7_loss as jax_loss
from cvpytorch_tpu.ops.boxes import xyxy_to_cxcywh as jax_xyxy_to_cxcywh
from cvpytorch_tpu_torch.models import yolov7
from cvpytorch_tpu_torch.models.losses.yolov5_loss import _build_level_targets
from cvpytorch_tpu_torch.models.losses.yolov7_loss import YOLOv7Loss
from cvpytorch_tpu_torch.ops.boxes import bbox_iou
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, check_train_losses_and_grads,
                                    check_val_and_infer, images, make_pair, targets,
                                    torch_targets, trains_validates_and_serves)

C = len(DICTIONARY)
HW = 64


def raw_maps(seed, hw=HW, dtype=np.float32):
    """(B, ny, nx, 3, 5 + C) raw maps of the three levels."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, hw // s, hw // s, 3, 5 + C) * 1.5).astype(dtype) for s in (8, 16, 32)]


def loss_targets(seed, hw=HW, dtype=np.float32, tie=True):
    """Normalised cxcywh targets; with ``tie``, image 0's gt 3 repeats gt
    1 (equal cost rows: the conflicts go to the first by ``argmin``)."""
    t = targets(hw, seed)
    if tie:
        t["boxes"][0, 3], t["labels"][0, 3] = t["boxes"][0, 1], t["labels"][0, 1]
    boxes = np.asarray(jax_xyxy_to_cxcywh(jnp.asarray(t["boxes"]))) / hw
    return {**t, "boxes": boxes.astype(dtype)}


def jax_ota(raw, t, hw):
    """The JAX loss's stage 2 (the selection and matched gt): its ``keep``
    mask, taken where the loss takes the ``argmax`` over the gts (the loss
    traced under ``jit`` with that ``argmax`` wrapped)."""
    loss = jax_loss.YOLOv7Loss(num_classes=C, anchors=jax_yolov7.V7_ANCHORS)
    orig = jnp.argmax

    def run(raw, t):
        seen = {}

        def argmax(a, axis=None, **k):
            if a.dtype == jnp.bool_ and axis == 1:
                seen["keep"] = a
            return orig(a, axis=axis, **k)

        jax_loss.jnp.argmax = argmax
        try:
            total, parts = loss(raw, t, img_size=float(hw))
        finally:
            jax_loss.jnp.argmax = orig
        return total, parts, seen["keep"]

    total, parts, keep = jax.jit(run)([jnp.asarray(r) for r in raw],
                                      {k: jnp.asarray(v) for k, v in t.items()})
    keep = np.asarray(keep)
    return keep.any(1), keep.argmax(1), float(total), {k: float(v) for k, v in parts.items()}


def port_ota(raw, t, hw):
    loss = YOLOv7Loss(num_classes=C, anchors=yolov7.V7_ANCHORS)
    tt = torch_targets(t)
    lvl = loss.candidates([torch.from_numpy(r) for r in raw], tt)
    sel, mg = loss.ota_match(lvl, tt, float(hw))
    total, parts = loss([torch.from_numpy(r) for r in raw], tt, float(hw))
    return sel.numpy(), mg.numpy(), float(total), {k: float(v) for k, v in parts.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ota_matches_and_loss_match_jax_float64(seed):
    """Float64 on both sides: the selection and matched gts equal, the
    loss terms within 1e-9 relative."""
    raw, t = raw_maps(seed, dtype=np.float64), loss_targets(seed + 4, dtype=np.float64)
    with jax.enable_x64(True):
        jsel, jmg, jtotal, jparts = jax_ota(raw, t, HW)
    sel, mg, total, parts = port_ota(raw, t, HW)
    np.testing.assert_array_equal(sel, jsel)
    np.testing.assert_array_equal(np.where(sel, mg, -1), np.where(jsel, jmg, -1))
    assert sel.sum() > 10 and not (mg[0][sel[0]] == 3).any()  # gt 3 repeats gt 1
    np.testing.assert_allclose(total, jtotal, rtol=1e-9)
    for k in jparts:
        np.testing.assert_allclose(parts[k], jparts[k], rtol=1e-9, err_msg=k)


def test_ota_matches_and_loss_match_jax_float32():
    """Float32, where the 1e8 terms make ties of the costs of invalid
    candidates (resolved by the stable ranks as by JAX's double argsort);
    the seed's dynamic-k sums lie ≥ 1e-4 from an integer."""
    raw, t = raw_maps(5), loss_targets(9)
    tt = torch_targets({k: v.astype(np.float64) if v.dtype.kind == "f" else v
                        for k, v in t.items()})
    loss = YOLOv7Loss(num_classes=C, anchors=yolov7.V7_ANCHORS)
    lvl = loss.candidates([torch.from_numpy(r).double() for r in raw], tt)
    gt_px = tt["boxes"] * HW
    iou = bbox_iou(gt_px[:, :, None], torch.cat([l["pbox"] for l in lvl], 1)[:, None],
                   fmt="cxcywh") * torch.cat([l["w"] for l in lvl], 1)[:, None]
    sums = iou.topk(20, -1).values.sum(-1)[tt["valid"]].detach().numpy()
    assert np.abs(sums - np.round(sums)).min() >= 1e-4 and sums.max() > 1
    jsel, jmg, jtotal, jparts = jax_ota(raw, t, HW)
    sel, mg, total, parts = port_ota(raw, t, HW)
    np.testing.assert_array_equal(sel, jsel)
    np.testing.assert_array_equal(np.where(sel, mg, -1), np.where(jsel, jmg, -1))
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(parts[k], jparts[k], rtol=1e-5, err_msg=k)


def test_candidates_are_yolov5s():
    """Stage 1 is YOLOv5's candidate builder, level by level."""
    t = torch_targets(loss_targets(3))
    anchors = torch.tensor(yolov7.V7_ANCHORS[1])
    got = _build_level_targets(t["boxes"], t["valid"], anchors, 4, 4, 4.0)
    assert got["w"].shape == (B, 5 * 3 * 5) and got["w"].sum() > 0


@pytest.mark.parametrize("in_ch,out,stride", [(16, 16, 1), (16, 32, 1), (16, 16, 2)])
def test_repconv_train_form_matches_jax(in_ch, out, stride):
    """The identity BN only at stride 1 with equal widths; eval mode,
    float32, within 1e-6 (train mode: the model's gradient test)."""
    x = np.random.RandomState(4).randn(B, 10, 6, in_ch).astype(np.float32)
    jm = jax_yolov7.RepConv(out, stride)
    variables = init_tree(jm, jnp.asarray(x), seed=2)
    tm = load_jax_variables(yolov7.RepConv(in_ch, out, stride), variables).eval()
    assert (tm.rbr_identity is not None) == (stride == 1 and in_ch == out)
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert_close_to_scale(got, jm.apply(variables, jnp.asarray(x)), 1e-6)


# -- the model ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_yolov7.YOLOv7, yolov7.YOLOv7, {"TYPE": "yolov7_n"}, HW)


def test_raw_maps_match_jax(pair):
    jm, variables, tm = pair
    x = images(HW)
    want = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._raw(i, tr)))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm._raw(torch.from_numpy(x))
    assert [g.shape for g in got] == [(B, 8, 8, 3, 5 + C), (B, 4, 4, 3, 5 + C),
                                      (B, 2, 2, 3, 5 + C)]
    for g, w in zip(got, want):
        assert_close_to_scale(g.numpy(), w)


def test_train_loss_and_grads_match_jax(pair):
    jm, variables, tm = pair
    check_train_losses_and_grads(jm, variables, tm, images(HW), targets(HW),
                                 ("box_loss", "obj_loss", "cls_loss"))


def test_val_and_infer_predictions_match_jax(pair):
    jm, variables, tm = pair
    check_val_and_infer(jm, variables, tm, images(HW, seed=1), targets(HW))


@pytest.mark.parametrize("type_", ["yolov7_n", "yolov7_l", "yolov7_x"])
def test_sizes_build_the_jax_model(type_):
    """As many parameters and BN statistics as the JAX model (shapes only,
    at 64²)."""
    kw = dict(dictionary=DICTIONARY, model_cfg={"TYPE": type_})
    shapes = jax.eval_shape(lambda: jax_yolov7.YOLOv7(**kw).init(jax.random.PRNGKey(0),
                                                                 jnp.zeros((1, 64, 64, 3))))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = yolov7.YOLOv7(**kw)
    got = sum(v.numel() for k, v in m.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == want


def test_yolov7_config_trains_validates_and_serves(tmp_path):
    """``conf/coco_yolov7x.yml`` (its ``YOLOv7Loss``, mosaic, SGD, EMA) at
    64² with ``TYPE`` yolov7_n's widths."""
    state = trains_validates_and_serves(tmp_path, "coco_yolov7x", TYPE="yolov7_n")
    assert type(state.model).__name__ == "YOLOv7" and state.model.stem1.conv.out_channels == 8
