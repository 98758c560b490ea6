"""The port's training loss path against the JAX package on the CPU,
float32: ``bbox_iou``, the YOLOv5 loss at one point, the per-leaf
gradients of the whole model in ``mode="train"``, and ``mode="val"``.

Inputs come from numpy seeds; weights are carried by
``load_jax_variables``.  The JAX package's opt-in ``CVT_*`` gates are
popped, so it runs its default float32 path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.losses.yolov5_loss import YOLOv5Loss as JaxLoss
from cvpytorch_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from cvpytorch_tpu_torch.models.losses.yolov5_loss import YOLOv5Loss
from cvpytorch_tpu_torch.models.yolov5 import DEFAULT_ANCHORS, STRIDES
from cvpytorch_tpu_torch.ops.boxes import bbox_iou
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten
from tests.test_torch_yolov5 import images, make_pair


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread (the training test files import this
    fixture too): with several test processes on one host, each with a
    pool of a thread per core, the pools' spinning stalls the many small
    operations of a train step (a 4 s test took 126 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

HW = 64


@pytest.fixture(autouse=True)
def jax_default_path(monkeypatch):
    monkeypatch.delenv("CVT_OBJ_SLICE", raising=False)
    monkeypatch.delenv("CVT_BN_BF16_STATS", raising=False)


@pytest.mark.parametrize("iou_type", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("fmt", ["xyxy", "cxcywh"])
def test_bbox_iou_matches_jax(iou_type, fmt):
    """Every type within 1e-6 (absolute, values in [-1.5, 1])."""
    rng = np.random.RandomState(7)
    a = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    b = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    if fmt == "xyxy":  # corners in order, with some disjoint and equal pairs
        a[:, 2:] = a[:, :2] + rng.uniform(0.1, 4, (64, 2))
        b[:, 2:] = b[:, :2] + rng.uniform(0.1, 4, (64, 2))
        b[:4] = a[:4]
    want = np.asarray(jax_bbox_iou(jnp.asarray(a), jnp.asarray(b), fmt, iou_type))
    got = bbox_iou(torch.from_numpy(a), torch.from_numpy(b), fmt, iou_type).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_ciou_alpha_is_detached():
    """CIoU's gradient treats alpha as a constant, as JAX's stop_gradient
    does: grads within 1e-6."""
    rng = np.random.RandomState(8)
    a = rng.uniform(1, 5, (16, 4)).astype(np.float32)
    b = rng.uniform(1, 5, (16, 4)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jax_bbox_iou(
        x, jnp.asarray(b), "cxcywh", "ciou").sum())(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_()
    bbox_iou(x, torch.from_numpy(b), "cxcywh", "ciou").sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-6, rtol=0)


def loss_inputs(seed=0, B=2, M=8, C=3):
    """Raw maps for 64² (8², 4², 2² grids) and targets: image 0 has boxes
    whose centres sit just either side of the cell middles (so every
    neighbour offset is taken) and at the border, plus padding; image 1 is
    all invalid."""
    rng = np.random.RandomState(seed)
    raw = [rng.randn(B, s, s, 3, 5 + C).astype(np.float32) for s in (8, 4, 2)]
    boxes = rng.uniform(0.1, 0.3, (B, M, 4)).astype(np.float32)
    cx = np.array([3.49, 3.51, 1.2, 6.8, 0.3, 7.7]) / 8
    cy = np.array([2.51, 5.49, 6.8, 1.2, 7.7, 0.3]) / 8
    boxes[0, :6, 0], boxes[0, :6, 1] = cx, cy
    boxes[0, :6, 2:] = rng.uniform(0.05, 0.6, (6, 2))
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    valid = np.zeros((B, M), bool)
    valid[0, :6] = True
    return raw, {"boxes": boxes, "labels": labels, "valid": valid}


def test_yolov5_loss_matches_jax():
    """Total and the three parts within 1e-5 relative."""
    raw, t = loss_inputs()
    kw = dict(num_classes=3, anchors=DEFAULT_ANCHORS, strides=STRIDES)
    jt, jparts = jax.jit(JaxLoss(**kw))([jnp.asarray(r) for r in raw],
                                        {k: jnp.asarray(v) for k, v in t.items()})
    tt, tparts = YOLOv5Loss(**kw)([torch.from_numpy(r) for r in raw],
                                  {k: torch.from_numpy(v) for k, v in t.items()})
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in ("box_loss", "obj_loss", "cls_loss"):
        assert float(jparts[k]) > 0
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]), rtol=1e-5)


def test_every_offset_has_a_positive():
    """The targets of ``loss_inputs`` reach all five cell offsets."""
    from cvpytorch_tpu_torch.models.losses.yolov5_loss import _build_level_targets

    _, t = loss_inputs()
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    anchors = torch.tensor(DEFAULT_ANCHORS[0])
    out = _build_level_targets(tt["boxes"], tt["valid"], anchors, 8, 8, 4.0)
    w = out["w"].reshape(2, 8, 3, 5)
    assert (w[0].sum((0, 1)) > 0).all()  # every offset o used
    assert float(w[1].sum()) == 0  # the all-invalid image has no candidate


def pixel_targets(seed=1, B=2, M=8, C=3):
    """xyxy pixel targets for a 64² batch, image 1 with padding rows."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(8, 56, (B, M, 2))
    wh = rng.uniform(6, 30, (B, M, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).clip(0, HW).astype(np.float32)
    valid = np.ones((B, M), bool)
    valid[1, 5:] = False
    return {"boxes": boxes, "labels": rng.randint(0, C, (B, M)).astype(np.int32),
            "valid": valid}


def _port_name(path):
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
    return ".".join(path[:-1] + (leaf,))


def test_train_mode_grads_match_jax_per_leaf():
    """Per-leaf grads of the whole YOLOv5-n at 64², B=2, in train mode:
    max |Δg| over max(leaf max |g|, 1e-3 · global max |g|) ≤ 5e-3, the
    bound of the JAX package's own grad differential.  The JAX stem's 3×3
    space-to-depth grad maps to the port's 6×6 grad as its kernel does."""
    jm, variables, tm = make_pair("yolov5_n", seed=2)
    x = images(2)
    tgt = pixel_targets()

    def loss_j(params):
        (total, _), _ = jm.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), targets={k: jnp.asarray(v) for k, v in tgt.items()},
                                 mode="train", mutable=["batch_stats"])
        return total

    jtotal, jgrads = jax.jit(jax.value_and_grad(loss_j))(variables["params"])
    tm.train()
    total, parts = tm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in tgt.items()},
                      mode="train")
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    assert set(parts) == {"box_loss", "obj_loss", "cls_loss", "loss"}
    grads = {n: p.grad for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        name = _port_name(path)
        pairs.append((name, _convert(name, g, grads[name]), grads[name].numpy()))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(t).max() for _, _, t in pairs)
    worst = max((float(np.abs(j - t).max() / max(np.abs(t).max(), 1e-3 * gmax)), n)
                for n, j, t in pairs)
    assert worst[0] <= 5e-3, worst


def test_val_mode_matches_jax():
    """Val-mode losses within 1e-5 relative; predictions as in
    ``test_infer_mode_matches_jax`` (labels, valid, num exactly; boxes and
    scores within 1e-4)."""
    jm, variables, tm = make_pair("yolov5_n", seed=0)
    x = images(0)
    tgt = pixel_targets()
    jl, jd = jax.jit(lambda v, img, t: jm.apply(v, img, targets=t, mode="val"))(
        variables, jnp.asarray(x), {k: jnp.asarray(v) for k, v in tgt.items()})
    with torch.no_grad():
        tl, td = tm.eval()(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in tgt.items()}, mode="val")
    for k in ("box_loss", "obj_loss", "cls_loss", "loss"):
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5)
    for key in ("labels", "valid", "num"):
        assert np.array_equal(td[key].numpy(), np.asarray(jd[key])), key
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]),
                                   atol=1e-4, rtol=1e-4)
    assert int(td["num"].min()) > 0
