"""The port's NanoDet-Plus (ShuffleNetV2, GhostPAN, the GFL head and loss,
the DSL assigner) against the JAX package on the CPU, with one set of
weights carried across by ``load_jax_variables``.

Tolerances: eval-mode maps and head outputs within 1e-5 of their largest
value; losses within 1e-5 relative; the assignment's ``matched_gt``
equal and ``matched_iou`` within 1e-6; predictions (labels, valid) equal,
boxes and scores within 1e-4; per-leaf gradients within 5e-3 of the
leaf's largest value, in float64 on both sides, as the other model tests
hold them.  Train-mode losses run at 128²: at 64² the stride-64 level is
one cell, so BN normalises over the batch's two values alone and float32
rounding of their difference reaches 1e-4 of the QFL loss.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.assigners.dsl_assigner import dsl_assign_batch
from cvpytorch_tpu.models.backbones.shufflenetv2 import ShuffleNetV2 as JaxShuffleNetV2
from cvpytorch_tpu.models.heads.nanodet_head import center_priors as jax_center_priors
from cvpytorch_tpu.models.losses import gfl_loss as jax_gfl
from cvpytorch_tpu.models.nanodet_plus import NanoDetPlus as JaxNanoDetPlus
from cvpytorch_tpu.models.necks import ghost_pan as jax_ghost_pan
from cvpytorch_tpu.ops.boxes import box_iou_matrix as jax_box_iou_matrix
from cvpytorch_tpu_torch.models.assigners.dsl_assigner import dsl_assign
from cvpytorch_tpu_torch.models.backbones.shufflenetv2 import ShuffleNetV2
from cvpytorch_tpu_torch.models.bricks import upsample2x_bilinear_align
from cvpytorch_tpu_torch.models.heads.nanodet_head import center_priors
from cvpytorch_tpu_torch.models.losses import gfl_loss
from cvpytorch_tpu_torch.models.nanodet_plus import NanoDetPlus
from cvpytorch_tpu_torch.models.necks.ghost_pan import GhostPAN
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree, init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"c{i}": 1.0} for i in range(4))
B = 2


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def assert_close_to_scale(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def images(hw, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def targets(hw, seed=1, M=4):
    """Boxes of 1/8 to 1/2 of the side, 3 and 2 of 4 valid."""
    r = np.random.RandomState(seed)
    xy = r.uniform(0, hw * 0.6, (B, M, 2))
    wh = r.uniform(hw / 8, hw / 2, (B, M, 2))
    return {"boxes": np.concatenate([xy, np.minimum(xy + wh, hw)], -1).astype(np.float32),
            "labels": r.randint(0, len(DICTIONARY), (B, M)).astype(np.int32),
            "valid": np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)}


def make_pair(use_aux_head, hw, seed=3):
    jm = JaxNanoDetPlus(dictionary=DICTIONARY, model_cfg={}, use_aux_head=use_aux_head)
    t = {k: jnp.asarray(v) for k, v in targets(hw).items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(images(hw)), t,
                                            mode="train"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(NanoDetPlus(dictionary=DICTIONARY, model_cfg={},
                                        use_aux_head=use_aux_head), variables)
    return jm, variables, tm.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "aux_head"])
def pair128(request):
    return make_pair(request.param, 128)


# -- modules ----------------------------------------------------------------------
@pytest.mark.parametrize("subtype,act,classifier", [
    ("shufflenetv2_x0.5", "relu", True),
    ("shufflenetv2_x1.0", "leaky_relu", False),
    ("shufflenetv2_x1.5", "leaky_relu", False),
    ("shufflenetv2_x2.0", "relu", False),
])
def test_shufflenetv2_matches_jax(subtype, act, classifier):
    """Eval mode at 64²: the three stage outputs (or the logits) within
    1e-5 of their largest value."""
    x = images(64)
    jm = JaxShuffleNetV2(subtype=subtype, act=act, classifier=classifier, num_classes=7)
    variables = init_tree(jm, jnp.asarray(x), seed=5)
    tm = load_jax_variables(ShuffleNetV2(subtype=subtype, act=act, classifier=classifier,
                                         num_classes=7), variables).eval()
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    if classifier:
        assert_close_to_scale(got.numpy(), want)
        return
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)
    assert [g.shape[1] for g in got] == tm.channels[1:4]


def test_upsample_matches_the_jax_matrix_form():
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    want = jax_ghost_pan.upsample2x_bilinear_ac(jnp.asarray(x))
    got = upsample2x_bilinear_align(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_blocks,extra", [(1, 1), (2, 2)])
def test_ghost_pan_matches_jax(num_blocks, extra):
    """Eval mode on (8², 4², 2²) maps of (16, 24, 32) channels: every
    output level within 1e-5 of its largest value."""
    rng = np.random.RandomState(2)
    feats = [rng.randn(B, s, s, c).astype(np.float32) for s, c in ((8, 16), (4, 24), (2, 32))]
    jm = jax_ghost_pan.GhostPAN(out_channels=12, num_blocks=num_blocks, num_extra_levels=extra)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=4)
    tm = load_jax_variables(GhostPAN((16, 24, 32), 12, num_blocks=num_blocks,
                                     num_extra_levels=extra), variables).eval()
    want = jm.apply(variables, tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert len(got) == len(want) == 3 + extra
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)


def test_ghost_module_cuts_to_odd_out_channels():
    """⌈out/ratio⌉ primary channels, the cheap conv grouped by them, the
    concatenation cut to ``out_channels``: 7 out of 4 + 4."""
    from cvpytorch_tpu_torch.models.necks.ghost_pan import GhostModule

    m = GhostModule(5, 7)
    assert m.primary.conv.out_channels == 4 and m.cheap.conv.groups == 4
    assert m(torch.randn(1, 5, 3, 3)).shape == (1, 7, 3, 3)


# -- losses -----------------------------------------------------------------------
def test_gfl_losses_match_jax():
    rng = np.random.RandomState(0)
    N, C, R = 50, 4, 8
    logits = (rng.randn(N, C) * 2).astype(np.float32)
    labels = rng.randint(0, C + 1, N).astype(np.int32)  # C = background
    scores = rng.rand(N).astype(np.float32)
    np.testing.assert_allclose(
        gfl_loss.quality_focal_loss(*map(torch.from_numpy, (logits, labels, scores))).numpy(),
        jax_gfl.quality_focal_loss(*map(jnp.asarray, (logits, labels, scores))),
        rtol=1e-5, atol=1e-7)
    dist = (rng.randn(N, R) * 2).astype(np.float32)
    tgt = rng.uniform(0, R - 1.1, N).astype(np.float32)
    tgt[:3] = [0.0, 3.0, R - 1.1]
    np.testing.assert_allclose(
        gfl_loss.distribution_focal_loss(torch.from_numpy(dist), torch.from_numpy(tgt)).numpy(),
        jax_gfl.distribution_focal_loss(jnp.asarray(dist), jnp.asarray(tgt)), rtol=1e-5)
    a = np.concatenate([rng.rand(N, 2) * 50, rng.rand(N, 2) * 50 + 60], 1).astype(np.float32)
    b = a + rng.randn(N, 4).astype(np.float32) * 8
    np.testing.assert_allclose(gfl_loss.giou_loss(torch.from_numpy(a), torch.from_numpy(b)),
                               jax_gfl.giou_loss(jnp.asarray(a), jnp.asarray(b)), rtol=1e-5)
    reg = rng.randn(3, 5, 4, R).astype(np.float32)
    np.testing.assert_allclose(gfl_loss.integral_project(torch.from_numpy(reg)).numpy(),
                               jax_gfl.integral_project(jnp.asarray(reg)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dsl_assign_matches_jax(seed):
    """The batched assigner against JAX's per-image one under ``vmap``:
    priors of a 128² pyramid (8, 16, 32, 64), predictions around them,
    6 gts of which some are invalid and some overlap; ``matched_gt``
    equal, ``matched_iou`` within 1e-6.  Every seed has priors taken by
    several gts (3 to 11), and at seed 0 one goes to a gt that did not
    take it, so both conflict rules run.  The per-gt sums of the 13
    largest IoUs of these seeds lie more than 1e-4 from an integer, so
    dynamic_k does not depend on the summation order."""
    rng = np.random.RandomState(seed)
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2)]
    priors = jax_center_priors(sizes, (8, 16, 32, 64))
    P = priors.shape[0]
    p = np.asarray(priors)
    logits = rng.randn(B, P, 5).astype(np.float32)
    ltrb = rng.uniform(0.5, 3.0, (B, P, 4)) * p[None, :, 2:3]
    decoded = np.concatenate([p[None, :, :2] - ltrb[..., :2], p[None, :, :2] + ltrb[..., 2:]],
                             -1).astype(np.float32)
    xy = rng.uniform(0, 90, (B, 6, 2))
    gt = np.concatenate([xy, xy + rng.uniform(12, 60, (B, 6, 2))], -1).astype(np.float32)
    gt[:, 5] = gt[:, 4] + 3  # an overlapping pair
    labels = rng.randint(0, 5, (B, 6)).astype(np.int32)
    valid = rng.rand(B, 6) < 0.8
    valid[:, 0] = True
    want = dsl_assign_batch(*map(jnp.asarray, (logits,)), priors,
                            *map(jnp.asarray, (decoded, gt, labels, valid)), 13, 3.0)
    got = dsl_assign(*map(torch.from_numpy, (logits,)), torch.from_numpy(p),
                     *map(torch.from_numpy, (decoded, gt, labels, valid)))
    ious = jax.vmap(lambda d, g: jax.lax.top_k(jax_box_iou_matrix(d, g).T, 13)[0])(
        jnp.asarray(decoded), jnp.asarray(gt))
    frac = np.asarray(ious).sum(-1) % 1
    assert (np.minimum(frac, 1 - frac) > 1e-4).all()
    np.testing.assert_array_equal(got["matched_gt"].numpy(), np.asarray(want["matched_gt"]))
    np.testing.assert_allclose(got["matched_iou"].numpy(), np.asarray(want["matched_iou"]),
                               atol=1e-6, rtol=0)
    assert (got["matched_gt"] >= 0).sum() > 10


def test_priors_match_jax():
    sizes = [(40, 40), (20, 20), (10, 10), (5, 5)]
    np.testing.assert_array_equal(center_priors(sizes, (8, 16, 32, 64)).numpy(),
                                  np.asarray(jax_center_priors(sizes, (8, 16, 32, 64))))


# -- the model ----------------------------------------------------------------------
@pytest.mark.parametrize("hw", [64, 128])
@pytest.mark.parametrize("use_aux_head", [False, True])
def test_head_outputs_match_jax(use_aux_head, hw):
    """Eval mode: the flat (B, P, C + 32) head outputs within 1e-5 of their
    largest value, the priors equal (P = 85 at 64², from a 1×1 stride-64
    map)."""
    jm, variables, tm = make_pair(use_aux_head, hw)
    x = images(hw)
    jp, _, jpriors, _ = jm.apply(variables, jnp.asarray(x),
                                 method=lambda m, a: m._forward(a, False))
    with torch.no_grad():
        tp, aux, tpriors = tm._forward(torch.from_numpy(x), False)
    assert aux is None and tp.shape == (B, jpriors.shape[0], 4 + 32)
    assert_close_to_scale(tp.numpy(), jp)
    np.testing.assert_array_equal(tpriors.numpy(), np.asarray(jpriors))


def jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, {k: jnp.asarray(v) for k, v in t.items()}, mode="train",
                                 mutable=["batch_stats"])
    return total, parts


def test_train_mode_losses_match_jax(pair128):
    jm, variables, tm = pair128
    x, t = images(128), targets(128)
    jtotal, jparts = jax.jit(lambda p: jax_train(jm, variables, p, jnp.asarray(x), t))(
        variables["params"])
    with torch.no_grad():
        total, parts = copy.deepcopy(tm).train()(
            torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in t.items()}, mode="train")
    names = {"qfl_loss", "bbox_loss", "dfl_loss", "loss"}
    if tm.aux_head is not None:
        names |= {"aux_qfl_loss", "aux_bbox_loss", "aux_dfl_loss"}
    assert set(parts) == set(jparts) | {"loss"} == names
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)


def test_train_mode_grads_match_jax(pair128):
    """Per leaf, max |Δg| ≤ 5e-3 of max(leaf max |g|, 1e-3 · global max
    |g|), float64 on both sides."""
    jm, variables, tm = pair128
    x, t = images(128), targets(128)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        jgrads = jax.jit(jax.grad(lambda p: jax_train(
            jm, as64, p, jnp.asarray(x, jnp.float64), t)[0]))(as64["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = copy.deepcopy(tm).double().train()
    total, _ = tm(torch.from_numpy(x).double(),
                  {k: torch.from_numpy(v) for k, v in t.items()}, mode="train")
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


def assert_predictions_equal(got, want):
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               atol=1e-4, rtol=1e-4)
    assert valid.sum() > 0


def test_val_and_infer_predictions_match_jax(pair128):
    """Val losses within 1e-5 relative; the val predictions (un-letterboxed
    by the targets' pads/scales) and the infer predictions through
    ``batched_nms`` equal."""
    jm, variables, tm = pair128
    x, t = images(128, seed=1), targets(128)
    t["pads"] = np.array([[0, 16], [8, 0]], np.float32)
    t["scales"] = np.array([[0.5, 0.5], [0.75, 0.75]], np.float32)
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    jl, jd = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(variables, jnp.asarray(x), jt)
    ji = jax.jit(lambda v, a: jm.apply(v, a, mode="infer"))(variables, jnp.asarray(x))
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in t.items()},
                    mode="val")
        ti = tm(torch.from_numpy(x), mode="infer")
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    assert td["boxes"].shape == (B, 100, 4)
    assert_predictions_equal(td, jd)
    assert_predictions_equal(ti, ji)


def test_unported_paths_raise_naming_the_roadmap():
    """NanoDet v1 and its PAN and TAN necks are ported (tests/
    test_torch_nanodet_v1.py, test_torch_tan.py): they build, as do YOLOX,
    PAI-YOLOX, YOLOv7, FCOS, LFD, RetinaNet and, since ROADMAP item 7.6,
    AIRDet, ObjectBox and the rest of item 7, and since item 9 the
    keypoint models under the configs' names; no JAX model is left in
    ``NOT_PORTED``, and a name no registry holds raises."""
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.infer import build_model

    assert NanoDetPlus(DICTIONARY, {}, assigner="atss").v1
    assert NanoDetPlus(DICTIONARY, {"CLASS": "src.models.nanodet.NanoDet"}).v1
    for neck in ("PAN", "TAN"):
        assert type(NanoDetPlus(DICTIONARY, {"NECK": {"name": neck}}).neck).__name__ == neck
    for cls in ("src.models.yolox.YOLOX", "src.models.pai_yolox.PAI_YOLOX",
                "src.models.yolov7.YOLOv7", "src.models.fcos.FCOS", "src.models.lfd.LFD",
                "src.models.retinanet.RetinaNet", "src.models.airdet.AIRDet",
                "src.models.objectbox.ObjectBox", "src.models.efficientdet.EfficientDet",
                "src.models.yolop.YOLOP", "src.models.fastestdet.FastestDet",
                "src.models.giraffedet.GiraffeDet"):
        with torch.device("meta"):
            model = build_model(CommonConfiguration({"USE_MODEL": {"CLASS": cls}}), DICTIONARY)
        assert type(model).__name__ == cls.split(".")[-1].replace("PAI_", ""), cls
    from cvpytorch_tpu_torch.infer import NOT_PORTED

    assert NOT_PORTED == {}
    for cls in ("src.models.litepose.LitePose", "src.models.openpose.OpenPose",
                "src.models.keypoint.SimplePose"):
        with torch.device("meta"):
            model = build_model(CommonConfiguration({"USE_MODEL": {"CLASS": cls}}), DICTIONARY)
        assert type(model).__name__ == cls.split(".")[-1], cls
    with pytest.raises(KeyError, match="unknown name"):
        build_model(CommonConfiguration({"USE_MODEL": {"CLASS": "src.models.x.NoSuchModel"}}),
                    DICTIONARY)
