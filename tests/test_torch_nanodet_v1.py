"""The port's NanoDet v1 (the ATSS assigner, (i + 0.5)·stride priors, the
v1 GFL loss, and the whole model on PAN and on TAN) against the JAX
package on the CPU, with one set of weights carried across by
``load_jax_variables``.

Tolerances: ``matched_gt`` equal and ``matched_iou`` within 1e-6 (both
ATSS flavours, with gts centred on cell boundaries, where priors tie in
distance, and padded gts); priors equal; head outputs within 1e-4 of
their largest value (float32, eval mode); losses within 1e-5 relative;
per-leaf gradients within 5e-3 of the leaf's largest value in float64 on
both sides (ROADMAP's known trap: BN and ReLU near-ties move float32
leaves); predictions after ``batched_nms``: labels and valid equal,
boxes and scores within 1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.assigners.atss_assigner import atss_assign as jax_atss_assign
from cvpytorch_tpu.models.heads import nanodet_head as jax_head
from cvpytorch_tpu.models.nanodet_plus import NanoDetPlus as JaxNanoDetPlus
from cvpytorch_tpu_torch.models.assigners.atss_assigner import atss_assign, grid_cells
from cvpytorch_tpu_torch.models.heads import nanodet_head
from cvpytorch_tpu_torch.models.nanodet_plus import NanoDetPlus
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_nanodet import assert_predictions_equal
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"c{i}": 1.0} for i in range(4))
B = 2
STRIDES = (8, 16, 32)


def assert_close_to_scale(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


def images(hw, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def targets(hw, seed=1, M=5):
    """Random boxes of 1/8 to 1/2 of the side, and a tall one (12 wide, 66
    or 60 high) centred on a corner of the stride-8 and stride-16 cells: on
    those levels its 5th to 12th closest priors tie in distance, with other
    IoUs, so which of them are among its 9 candidates moves its threshold
    and its positives (the other tie rule, higher index first, changes
    ``matched_gt``).  One padded slot in each image and one more in the
    second."""
    r = np.random.RandomState(seed)
    xy = r.uniform(0, hw * 0.6, (B, M, 2))
    wh = r.uniform(hw / 8, hw / 2, (B, M, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, hw)], -1)
    half_h = {64: 33, 128: 30}[hw]
    boxes[:, 0] = [hw / 4 - 6, hw / 4 - half_h, hw / 4 + 6, hw / 4 + half_h]
    return {"boxes": boxes.astype(np.float32),
            "labels": r.randint(0, len(DICTIONARY), (B, M)).astype(np.int32),
            "valid": np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)}


# -- the assigner ---------------------------------------------------------------------
def pyramid_priors(hw):
    sizes = [(hw // s, hw // s) for s in STRIDES]
    return jax_head.center_priors_v1(sizes, STRIDES), tuple(h * w for h, w in sizes)


def assign_pair(seed, flavour, hw=64):
    jpriors, nlp = pyramid_priors(hw)
    p = np.asarray(jpriors)
    kw = dict(topk=9) if flavour == "gfl" else dict(topk=9, center_eps=1e-9, strict_thr=True,
                                                    dedup_unmasked=True)
    scale = 5
    half = 0.5 * scale * p[:, 2]
    jcells = np.stack([p[:, 0] - half, p[:, 1] - half, p[:, 0] + half, p[:, 1] + half], -1)
    t = targets(hw, seed)
    want = jax.vmap(lambda gb, gl, gv: jax_atss_assign(jpriors, nlp, jnp.asarray(jcells), gb, gl, gv,
                                                       **kw))(
        *(jnp.asarray(t[k]) for k in ("boxes", "labels", "valid")))
    tp = torch.from_numpy(p)
    got = atss_assign(tp, nlp, grid_cells(tp, scale), torch.from_numpy(t["boxes"]),
                      torch.from_numpy(t["valid"]), **kw)
    np.testing.assert_array_equal(grid_cells(tp, scale).numpy(), jcells)
    return got, want, t, p, nlp


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("flavour", ["gfl", "yolov6"])
def test_atss_assign_matches_jax(flavour, seed):
    """The batched assigner against JAX's per-image one under ``vmap`` on a
    64² pyramid (8, 16, 32): both flavours (GFL: ``>=`` threshold,
    ``center_eps`` 0.01, the argmax over the prior's own positives;
    YOLOv6's warm-up: strict, 1e-9, the argmax over every valid gt).  The
    first gt's centre sits on a cell corner of the two finer levels, where
    the 9th and 10th closest priors of a level lie at exactly one distance,
    so the tie rule (lower index first) picks the candidates and the
    positives."""
    got, want, t, p, nlp = assign_pair(seed, flavour)
    np.testing.assert_array_equal(got["matched_gt"].numpy(), np.asarray(want["matched_gt"]))
    np.testing.assert_allclose(got["matched_iou"].numpy(), np.asarray(want["matched_iou"]),
                               atol=1e-6, rtol=0)
    assert (got["matched_gt"] >= 0).sum() > 5
    # the tie: on level 0 the 9th and 10th distances from the first gt's centre are equal
    c = t["boxes"][0, 0]
    d = np.sqrt((p[:nlp[0], 0] - (c[0] + c[2]) / 2) ** 2 + (p[:nlp[0], 1] - (c[1] + c[3]) / 2) ** 2)
    d = np.sort(d.astype(np.float32))
    assert d[8] == d[9]


def test_atss_ignores_padded_gts():
    """A padded gt slot is never matched, whatever its box."""
    got, _, t, _, _ = assign_pair(0, "gfl")
    for b in range(B):
        padded = np.where(~t["valid"][b])[0]
        assert not np.isin(got["matched_gt"][b].numpy(), padded).any()


def test_priors_v1_match_jax():
    sizes = [(40, 40), (20, 20), (10, 10)]
    np.testing.assert_array_equal(nanodet_head.center_priors_v1(sizes, STRIDES).numpy(),
                                  np.asarray(jax_head.center_priors_v1(sizes, STRIDES)))


def test_aligned_iou_matches_jax():
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.rand(50, 2) * 50, rng.rand(50, 2) * 50 + 40], 1).astype(np.float32)
    b = a + rng.randn(50, 4).astype(np.float32) * 10
    b[:5] = a[:5] + 200  # disjoint
    np.testing.assert_allclose(nanodet_head._aligned_iou(torch.from_numpy(a), torch.from_numpy(b)),
                               jax_head._aligned_iou(jnp.asarray(a), jnp.asarray(b)), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_v1_loss_matches_jax(seed):
    """``nanodet_v1_loss`` at one point: head outputs drawn around the
    priors at 64², C = 4, reg_max 7; the three terms within 1e-5."""
    jpriors, nlp = pyramid_priors(64)
    rng = np.random.RandomState(seed)
    preds = rng.randn(B, jpriors.shape[0], 4 + 32).astype(np.float32)
    t = targets(64, seed + 5)
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    jtotal, jparts = jax_head.nanodet_v1_loss(jnp.asarray(preds), jpriors, jt, 4, 7, nlp)
    total, parts = nanodet_head.nanodet_v1_loss(
        torch.from_numpy(preds), torch.from_numpy(np.asarray(jpriors)),
        {k: torch.from_numpy(v) for k, v in t.items()}, 4, 7, nlp)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)


# -- the model ------------------------------------------------------------------------
CONFIGS = {
    # coco_nanodet: ShuffleNetV2-1.0, PAN, strides 8-32 (widths cut to 32)
    "pan": {"CLASS": "src.models.nanodet.NanoDet",
            "BACKBONE": {"name": "ShuffleNetV2", "subtype": "shufflenetv2_x1.0",
                         "act": "leaky_relu"}},
    # coco_nanodet_t: TAN on the stride-16 map (8² at 128²), dropout off
    "tan": {"CLASS": "src.models.nanodet.NanoDet",
            "BACKBONE": {"name": "ShuffleNetV2", "subtype": "shufflenetv2_x1.0",
                         "act": "leaky_relu"},
            "NECK": {"name": "TAN", "out_channels": 32, "feature_hw": [8, 8], "num_heads": 8,
                     "num_encoders": 1, "mlp_ratio": 4, "dropout_ratio": 0.0}},
}


def make_pair(name, hw=128, seed=3):
    kw = dict(dictionary=DICTIONARY, model_cfg=CONFIGS[name], feat_channels=32,
              strides=STRIDES)
    jm = JaxNanoDetPlus(**kw)
    t = {k: jnp.asarray(v) for k, v in targets(hw).items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(images(hw)), t,
                                            mode="train"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(NanoDetPlus(**kw), variables)
    return jm, variables, tm.eval()


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair128(request):
    return make_pair(request.param)


def test_v1_is_selected_by_class_or_assigner():
    """The v1 path: PAN by default, 3×3 head stacks, three levels."""
    m = NanoDetPlus(DICTIONARY, {"CLASS": "src.models.nanodet.NanoDet"}, strides=STRIDES)
    assert m.v1 and type(m.neck).__name__ == "PAN" and m.head.convs0_0_dw.conv.kernel_size == (3, 3)
    m = NanoDetPlus(DICTIONARY, {}, assigner="atss", strides=STRIDES)
    assert m.v1 and type(m.neck).__name__ == "PAN"
    m = NanoDetPlus(DICTIONARY, {})
    assert not m.v1 and type(m.neck).__name__ == "GhostPAN"
    assert m.head.convs0_0_dw.conv.kernel_size == (5, 5)


def test_head_outputs_and_priors_match_jax(pair128):
    jm, variables, tm = pair128
    x = images(128)
    jp, _, jpriors, jnlp = jm.apply(variables, jnp.asarray(x),
                                    method=lambda m, a: m._forward(a, False))
    with torch.no_grad():
        tp, aux, tpriors, nlp = tm._forward_levels(torch.from_numpy(x), False)
    assert aux is None and tuple(nlp) == tuple(jnlp) == (256, 64, 16)
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
    assert set(parts) == set(jparts) | {"loss"} == {"qfl_loss", "bbox_loss", "dfl_loss", "loss"}
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
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}.get(path[-1], path[-1])
        name = ".".join(path[:-1] + (leaf,))
        pairs.append((name, _convert(name, g, tm.state_dict()[name],
                                     owners.get(".".join(path[:-1]))), grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= 5e-3, worst


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
