"""The port's YOLOX and PAI-YOLOX (Focus, ASFF and its nearest resize, the
SimOTA assigner in both cost variants, the loss, and the whole model at
yolox_n's multipliers at 64² on the CSPDarknet and on PAI's EfficientRep + ASFF)
against the JAX package on the CPU, with one set of weights carried
across by ``load_jax_variables``.

Tolerances: Focus and the nearest resize equal; ASFF within 1e-6 of its
largest output (float32, eval mode) and 1e-9 in float64 train mode;
SimOTA's ``matched_gt`` equal, index for index (constructed ties of cost
and of IoU included), ``matched_iou`` within 1e-6 (1e-12 in float64); the
head outputs within 1e-4 of their largest value (float32, eval mode); the
train-mode loss terms within 1e-9 relative and every gradient leaf within
1e-6 of its largest value (float64 on both sides: BN and ReLU near-ties
move single float32 leaves); val losses within 1e-9 relative and the val
predictions through ``batched_nms`` (labels and valid equal,
scores 1e-7, boxes 1e-4 px: the port's NMS hands out float32) from float64
networks; the infer predictions equal the val ones under the identity
letterbox.

The shared helpers (``make_pair``, the float64 loss, gradient and
prediction checks) serve ``test_torch_yolov7.py`` and
``test_torch_fcos_lfd_retinanet.py`` too.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import yolox as jax_yolox
from cvpytorch_tpu.models.assigners.ota_assigner import simota_assign as jax_simota
from cvpytorch_tpu.models.heads.nanodet_head import center_priors as jax_center_priors
from cvpytorch_tpu.models.necks import asff as jax_asff
from cvpytorch_tpu.ops.boxes import box_iou_matrix
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import yolox
from cvpytorch_tpu_torch.models.assigners.ota_assigner import simota_assign
from cvpytorch_tpu_torch.models.light_seg import resize_nearest
from cvpytorch_tpu_torch.models.necks.asff import ASFF
from cvpytorch_tpu_torch.registry import MODELS
from cvpytorch_tpu_torch.train_state import make_predict_step
from cvpytorch_tpu_torch.trainer import Trainer
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables, port_name
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import fill_tree, init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_det_v1_v6_trainer import write_config
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"c{i}": 1.0} for i in range(4))
B = 2


def images(hw, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def targets(hw, seed=1, M=5):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, hw * 0.6, (B, M, 2))
    wh = r.uniform(hw / 6, hw / 2, (B, M, 2))
    return {"boxes": np.concatenate([xy, np.minimum(xy + wh, hw)], -1).astype(np.float32),
            "labels": r.randint(0, len(DICTIONARY), (B, M)).astype(np.int32),
            "valid": np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)}


def as64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def torch_targets(t, dtype=None):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}
    return out


# -- shared model checks -------------------------------------------------------------
def make_pair(jax_cls, port_cls, model_cfg, hw, seed=3, t=None):
    """The JAX model's variables from seeded numpy (``fill_tree``) and the
    port model carrying them, in eval mode."""
    kw = dict(dictionary=DICTIONARY, model_cfg=model_cfg)
    jm = jax_cls(**kw)
    t = targets(hw) if t is None else t
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(images(hw)),
                                            {k: jnp.asarray(v) for k, v in t.items()},
                                            mode="train"))
    variables = fill_tree(shapes, seed)
    return jm, variables, load_jax_variables(port_cls(**kw), variables).eval()


def jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({**variables, "params": params}, x,
                                 {k: jnp.asarray(v) for k, v in t.items()}, mode="train",
                                 mutable=["batch_stats"])
    return total, parts


def check_train_losses_and_grads(jm, variables, tm, x, t, names, grad_tol=1e-6, grads=True):
    """Float64 on both sides: every loss term within 1e-9 relative, and per
    leaf max |Δg| ≤ ``grad_tol`` of max(leaf max |g|, 1e-3 · global max
    |g|).  ``grads`` False checks the loss terms alone (JAX compiles no
    backward pass: XLA's compile of a detector's float64 backward takes
    10–25 s on the CPU)."""
    v64 = as64(variables)
    t64 = {k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v
           for k, v in t.items()}
    with jax.enable_x64(True):
        loss = lambda p: jax_train(jm, v64, p, jnp.asarray(x, jnp.float64), t64)  # noqa: E731
        if grads:
            (_, jparts), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v64["params"])
            jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        else:
            _, jparts = jax.jit(loss)(v64["params"])
        jparts = {k: float(v) for k, v in jparts.items()}
    tm = copy.deepcopy(tm).double().train()
    total, parts = tm(torch.from_numpy(x).double(), torch_targets(t64), mode="train")
    assert set(parts) == set(jparts) | {"loss"} == set(names) | {"loss"}
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), jparts[k], rtol=1e-9, err_msg=k)
    if not grads:
        return
    total.backward()
    owners = dict(tm.named_modules())
    # a leaf the loss does not reach (a backbone stage after the last
    # feature) has no gradient in torch and a zero one in JAX
    grads = {n: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))
             for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        name = port_name("params", path, grads)
        pairs.append((name, _convert(name, g, tm.state_dict()[name],
                                     owners.get(".".join(path[:-1]))), grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= grad_tol, worst


def assert_predictions_equal(got, want, min_valid=20):
    assert got["valid"].sum() >= min_valid
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-7, rtol=0)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], atol=1e-4, rtol=0)


def check_val_and_infer(jm, variables, tm, x, t, min_valid=20):
    """Val losses (1e-9 relative) and the val predictions through
    ``batched_nms``, un-letterboxed, against JAX, float64 on both sides;
    the infer mode's predictions are the val mode's with the identity
    letterbox (JAX's infer mode runs the same ``_predict`` without
    targets)."""
    t = {**{k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v
            for k, v in t.items()},
         "pads": np.array([[0, 16], [8, 0]], np.float64),
         "scales": np.array([[0.5, 0.5], [0.75, 0.75]], np.float64)}
    with jax.enable_x64(True):
        v64 = as64(variables)
        jl, jd = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
            v64, jnp.asarray(x, jnp.float64), {k: jnp.asarray(v) for k, v in t.items()})
        jl, jd = jax.tree_util.tree_map(np.asarray, (jl, jd))
    tm = copy.deepcopy(tm).double()
    identity = {**t, "pads": np.zeros((B, 2)), "scales": np.ones((B, 2))}
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x).double(), torch_targets(t), mode="val")
        ti = tm(torch.from_numpy(x).double(), mode="infer")
        tv = tm(torch.from_numpy(x).double(), torch_targets(identity), mode="val")[1]
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-9, err_msg=k)
    assert_predictions_equal(td, jd, min_valid)
    for k in ti:
        assert torch.equal(ti[k], tv[k]), k


def trains_validates_and_serves(tmp_path, name, size=64, **model):
    """``conf/<name>.yml`` through the port's ``Trainer.run()`` and
    ``infer.main`` on the CPU, its dataset swapped for
    ``SyntheticDetection`` and its sizes cut (``size``² letterbox or
    mosaic, batch 2, one train step, a val epoch of 2 batches;
    ``USE_MODEL`` keys overridden by ``model``): finite losses and mAP, and
    the served boxes equal the predict step's on the checkpoint's EMA
    weights, un-letterboxed.  Returns the trained state."""
    setting = write_config(tmp_path, name, train_len=2, size=size)
    raw = json.loads(open(setting).read())
    raw["USE_MODEL"].update(model)
    with open(setting, "w") as f:
        json.dump(raw, f)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    results = []
    val_epoch = trainer.val_epoch
    trainer.val_epoch = lambda *a: results.append(val_epoch(*a)) or results[-1]
    state = trainer.run()
    assert state.step == 1 and state.ema is not None
    (perf, metrics), = results
    assert np.isfinite(perf) and perf == metrics["mAP"]
    infer.main(["--setting", setting, "--checkpoint",
                os.path.join(trainer.checkpoints.save_dir, "last.pt"),
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    got = json.loads((tmp_path / "served" / "predictions.json").read_text())
    batch = next(iter(torch.utils.data.DataLoader(
        trainer.datasets["val"], batch_size=4, collate_fn=trainer.dataloaders["val"].collate_fn)))
    t = batch["target"]
    want = make_predict_step(state.ema)(
        torch.from_numpy(np.asarray(batch["image"])),
        {k: torch.from_numpy(np.asarray(t[k])) for k in ("pads", "scales")})
    assert len(got) == 4
    for i, g in enumerate(got):
        v = want["valid"][i]
        assert g["labels"] == want["labels"][i][v].tolist()
        np.testing.assert_allclose(np.reshape(g["boxes"], (-1, 4)), want["boxes"][i][v].numpy(),
                                   atol=1e-3)
    return state


# -- Focus, the nearest resize, ASFF -----------------------------------------------------
def test_focus_matches_jax():
    """The four phases in JAX's channel order (tl, bl, tr, br), the stem
    kernel carried, not permuted: float32 within 1e-6."""
    x = np.random.RandomState(0).rand(B, 10, 14, 3).astype(np.float32)
    jm = jax_yolox.Focus(16)
    variables = init_tree(jm, jnp.asarray(x), seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = load_jax_variables(yolox.Focus(3, 16), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert_close_to_scale(got, want, 1e-6)


@pytest.mark.parametrize("src,dst", [((13, 10), (4, 3)), ((4, 3), (13, 10)), ((7, 5), (13, 10)),
                                     ((13, 10), (7, 5)), ((9, 6), (9, 2))])
def test_resize_nearest_equals_jax(src, dst):
    """Down and up, by ratios that do not divide, on non-square maps."""
    x = np.random.RandomState(1).rand(1, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 3), "nearest"))
    np.testing.assert_array_equal(resize_nearest(nchw(x), dst).permute(0, 2, 3, 1).numpy(), want)


def test_asff_matches_jax():
    """Three levels of non-square maps whose sizes do not divide evenly
    (13×10, 7×5, 4×3): eval mode in float32, train mode and the running
    statistics in float64."""
    rng = np.random.RandomState(2)
    chs = (16, 32, 64)
    feats = [rng.randn(B, h, w, c).astype(np.float32)
             for (h, w), c in zip(((13, 10), (7, 5), (4, 3)), chs)]
    jm = jax_asff.ASFF(channels=16)
    jf = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jf, seed=4)
    tm = load_jax_variables(ASFF(chs, 16), variables).eval()
    want = jax.jit(jm.apply)(variables, jf)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w, 1e-6)
    v64 = as64(variables)
    with jax.enable_x64(True):
        want, new = jax.jit(lambda v, f: jm.apply(v, f, train=True, mutable=["batch_stats"]))(
            v64, tuple(jnp.asarray(f, jnp.float64) for f in feats))
        want = [np.asarray(w) for w in want]
        new = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    trained = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        got = trained([nchw(f).double() for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w, 1e-9)
    stats = load_jax_variables(copy.deepcopy(tm).double(), {**v64, "batch_stats": new})
    for k, v in trained.state_dict().items():
        if "running" in k:
            assert_close_to_scale(v.numpy(), stats.state_dict()[k].numpy(), 1e-9)


# -- SimOTA ------------------------------------------------------------------------------
def simota_inputs(seed, dtype=np.float32):
    """64² at strides 8–32 (84 priors): predictions around the priors,
    five gts (padded), and constructed ties: image 0's gt 3 repeats gt 1
    (equal cost columns, the conflict goes to the first), priors 20 and 21
    share one prediction (equal costs and IoUs within a column)."""
    sizes = [(8, 8), (4, 4), (2, 2)]
    priors = np.array(jax_center_priors(sizes, (8, 16, 32)))
    P = priors.shape[0]
    rng = np.random.RandomState(seed)
    preds = np.concatenate([rng.randn(B, P, 2) * 0.5 + 0.5, rng.randn(B, P, 2) * 0.4 + 0.7,
                            rng.randn(B, P, 1 + len(DICTIONARY)) * 2], -1)
    preds[:, 21] = preds[:, 20]
    boxes = np.asarray(jax_yolox.decode_yolox(jnp.asarray(preds, jnp.float32),
                                              jnp.asarray(priors)))
    t = targets(64, seed + 5)
    t["boxes"][0, 3], t["labels"][0, 3] = t["boxes"][0, 1], t["labels"][0, 1]
    sig = lambda a: 1 / (1 + np.exp(-a))  # noqa: E731
    return ([sig(preds[..., 5:]).astype(dtype), sig(preds[..., 4]).astype(dtype),
             priors.astype(dtype), boxes.astype(dtype), t["boxes"].astype(dtype)],
            t["labels"], t["valid"])


def dynamic_k_sums(inputs, valid, topk=10):
    """The Σ of each valid gt's ``topk`` largest candidate IoUs, in
    float64 (JAX's definition: candidates in any gt's box or centre
    window)."""
    _, _, priors, boxes, gts = (np.asarray(a, np.float64) for a in inputs)
    cx, cy, r = priors[None, :, 0, None], priors[None, :, 1, None], 2.5 * priors[None, :, 2, None]
    g = gts[:, None]
    in_box = (cx > g[..., 0]) & (cx < g[..., 2]) & (cy > g[..., 1]) & (cy < g[..., 3])
    in_center = ((np.abs(cx - (g[..., 0] + g[..., 2]) / 2) < r)
                 & (np.abs(cy - (g[..., 1] + g[..., 3]) / 2) < r))
    rows = ((in_box | in_center) & valid[:, None]).any(-1)
    ious = np.asarray(jax.vmap(box_iou_matrix)(jnp.asarray(boxes), jnp.asarray(gts)))
    ious = ious * rows[..., None]
    return np.sort(ious, 1)[:, ::-1][:, :topk].sum(1)[valid]


def run_simota(inputs, labels, valid, soft_label):
    want = jax.jit(jax.vmap(lambda c, o, d, gb, gl, gv: jax_simota(
        c, o, jnp.asarray(inputs[2]), d, gb, gl, gv, soft_label=soft_label)))(
        *map(jnp.asarray, (inputs[0], inputs[1], inputs[3], inputs[4], labels, valid)))
    got = simota_assign(*map(torch.from_numpy, inputs), torch.from_numpy(labels),
                        torch.from_numpy(valid), soft_label=soft_label)
    return got, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("soft_label", [False, True], ids=["yolox", "soft"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_matches_jax_float64(seed, soft_label):
    """Float64 on both sides (the dynamic-k sums truncate alike)."""
    inputs, labels, valid = simota_inputs(seed, np.float64)
    with jax.enable_x64(True):
        got, want = run_simota(inputs, labels, valid, soft_label)
    np.testing.assert_array_equal(got["matched_gt"].numpy(), want["matched_gt"])
    np.testing.assert_allclose(got["matched_iou"].numpy(), want["matched_iou"], atol=1e-12)
    m = got["matched_gt"].numpy()
    assert (m >= 0).sum() > 10 and not (m[0] == 3).any()  # gt 3 repeats gt 1: never kept
    assert m[0][m[0] >= 0].size and all(not np.isin(m[b], np.where(~valid[b])[0]).any()
                                        for b in range(B))


@pytest.mark.parametrize("soft_label", [False, True], ids=["yolox", "soft"])
def test_simota_matches_jax_float32(soft_label):
    """Float32, where 1e8 swamps the costs off the strong region (they
    round to multiples of 8 and tie; the stable ranks resolve them as
    JAX's argsort).  The seed's dynamic-k sums lie ≥ 1e-4 from an
    integer, so the truncation cannot flip between the frameworks."""
    inputs, labels, valid = simota_inputs(3)
    sums = dynamic_k_sums(inputs, valid)
    assert np.abs(sums - np.round(sums)).min() >= 1e-4 and sums.max() > 1
    got, want = run_simota(inputs, labels, valid, soft_label)
    np.testing.assert_array_equal(got["matched_gt"].numpy(), want["matched_gt"])
    np.testing.assert_allclose(got["matched_iou"].numpy(), want["matched_iou"], atol=1e-6)
    assert (got["matched_gt"] >= 0).sum() > 10


# -- the model ---------------------------------------------------------------------------
VARIANTS = {"yolox_n": {"TYPE": "yolox_n"}, "pai_yolox_n": {"TYPE": "pai_yolox_n"}}
HW = 64


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return make_pair(jax_yolox.YOLOX, yolox.YOLOX, VARIANTS[request.param], HW)


def test_head_outputs_match_jax(pair):
    jm, variables, tm = pair
    x = images(HW)
    jp, jpriors = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._forward(
        i, tr)))(variables, jnp.asarray(x))
    with torch.no_grad():
        tp, tpriors = tm._forward(torch.from_numpy(x))
    assert tp.shape == (B, 84, 5 + len(DICTIONARY))
    assert (tm.asff is not None) == tm.pai == (type(tm.backbone).__name__ == "EfficientRep")
    assert_close_to_scale(tp.numpy(), jp)
    np.testing.assert_array_equal(tpriors.numpy(), np.asarray(jpriors))


def test_train_loss_and_grads_match_jax(pair):
    jm, variables, tm = pair
    check_train_losses_and_grads(jm, variables, tm, images(HW), targets(HW),
                                 ("obj_loss", "cls_loss", "iou_loss"))


def test_val_and_infer_predictions_match_jax(pair):
    jm, variables, tm = pair
    check_val_and_infer(jm, variables, tm, images(HW, seed=1), targets(HW))


@pytest.mark.parametrize("type_", ["yolox_n", "yolox_s", "yolox_m", "yolox_l", "yolox_x",
                                   "pai_yolox_s"])
def test_sizes_build_the_jax_model(type_):
    """As many parameters and BN statistics as the JAX model (shapes only,
    at 64²)."""
    kw = dict(dictionary=DICTIONARY, model_cfg={"TYPE": type_})
    shapes = jax.eval_shape(lambda: jax_yolox.YOLOX(**kw).init(jax.random.PRNGKey(0),
                                                               jnp.zeros((1, 64, 64, 3))))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = yolox.YOLOX(**kw)
    got = sum(v.numel() for k, v in m.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == want


def test_pai_yolox_config_trains_validates_and_serves(tmp_path):
    """``conf/coco_pai_yolox.yml`` names ``src.models.pai_yolox.PAI_YOLOX``:
    the trainer and ``infer`` resolve it through the alias to ``YOLOX``,
    whose ``pai`` ``TYPE`` builds EfficientRep with ASFF (the config's
    ``NECK: {use_asff: True}`` is not read, as in JAX)."""
    assert MODELS.get("src.models.pai_yolox.PAI_YOLOX") is yolox.YOLOX is MODELS.get("PAIYOLOX")
    cfg = CommonConfiguration.from_file(os.path.join(os.path.dirname(__file__), "..", "conf",
                                                     "coco_pai_yolox.yml"))
    with torch.device("meta"):
        built = infer.build_model(cfg, DICTIONARY)
    assert type(built) is yolox.YOLOX and built.pai and built.asff is not None
    state = trains_validates_and_serves(tmp_path, "coco_pai_yolox")
    assert state.model.pai and type(state.model.backbone).__name__ == "EfficientRep"


def test_yolox_config_trains_validates_and_serves(tmp_path):
    """``conf/coco_yolox_n.yml``: the CSPDarknet with its Focus stem."""
    state = trains_validates_and_serves(tmp_path, "coco_yolox_n")
    assert not state.model.pai and type(state.model.backbone).__name__ == "YOLOXCSPDarknet"
