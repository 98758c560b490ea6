"""The port's YOLOv6 (the TAL assigner, the loss on both sides of its ATSS
→ TAL switch, RepBiPAN, and the whole model at yolov6_n's multipliers)
against the JAX package on the CPU, with one set of weights carried
across by ``load_jax_variables``.

Tolerances: ``matched_gt`` equal, ``matched_iou`` and ``align_metric``
within 1e-6; losses within 1e-5 relative (epoch 3: ATSS, epoch 4 and no
epoch: TAL), the whole model's train-mode terms within 1e-9 in float64;
head outputs within 1e-4 of their largest value (float32,
eval mode); RepBiPAN's outputs as the backbones' (float32 eval, float64
train); per-leaf gradients within 5e-3 of the leaf's largest value in
float64 on both sides; predictions after ``batched_nms``: labels and
valid equal, boxes and scores within 1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import yolov6 as jax_yolov6
from cvpytorch_tpu.models.assigners.tal_assigner import tal_assign as jax_tal_assign
from cvpytorch_tpu.models.heads.nanodet_head import center_priors as jax_center_priors
from cvpytorch_tpu_torch.models import yolov6
from cvpytorch_tpu_torch.models.assigners.tal_assigner import tal_assign
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_tan import nchw
from tests.test_torch_rcnn_ops import fill_tree, init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"c{i}": 1.0} for i in range(4))
B = 2
STRIDES = (8, 16, 32)


def images(hw, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def targets(hw, seed=1, M=5):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, hw * 0.6, (B, M, 2))
    wh = r.uniform(hw / 6, hw / 2, (B, M, 2))
    return {"boxes": np.concatenate([xy, np.minimum(xy + wh, hw)], -1).astype(np.float32),
            "labels": r.randint(0, len(DICTIONARY), (B, M)).astype(np.int32),
            "valid": np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)}


def priors(hw):
    sizes = [(hw // s, hw // s) for s in STRIDES]
    p = np.array(jax_center_priors(sizes, STRIDES))
    p[:, :2] += p[:, 2:] * 0.5
    return p, tuple(h * w for h, w in sizes)


def predictions(hw, seed):
    """Head outputs around the priors: ltrb of 0.5–4 strides, logits."""
    p, _ = priors(hw)
    rng = np.random.RandomState(seed)
    reg = rng.uniform(0.5, 4.0, (B, p.shape[0], 4))
    return np.concatenate([reg, rng.randn(B, p.shape[0], len(DICTIONARY)) * 2], -1).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tal_assign_matches_jax(seed):
    """The batched assigner against JAX's per-image one under ``vmap`` at
    64² (strides 8–32): gts that overlap (priors taken by several gts),
    padded gts."""
    p, _ = priors(64)
    preds = predictions(64, seed)
    scores = 1 / (1 + np.exp(-preds[..., 4:]))
    boxes = np.asarray(jax_yolov6.decode_yolov6(jnp.asarray(preds), jnp.asarray(p)))
    t = targets(64, seed + 3)
    t["boxes"][:, 1] = t["boxes"][:, 0] + 2  # an overlapping pair
    want = jax.vmap(lambda s, d, gb, gl, gv: jax_tal_assign(s, jnp.asarray(p), d, gb, gl, gv))(
        *map(jnp.asarray, (scores, boxes, t["boxes"], t["labels"], t["valid"])))
    got = tal_assign(*map(torch.from_numpy, (scores, p, boxes, t["boxes"], t["labels"],
                                             t["valid"])))
    np.testing.assert_array_equal(got["matched_gt"].numpy(), np.asarray(want["matched_gt"]))
    for k in ("matched_iou", "align_metric"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0,
                                   err_msg=k)
    assert (got["matched_gt"] >= 0).sum() > 10
    for b in range(B):
        assert not np.isin(got["matched_gt"][b].numpy(), np.where(~t["valid"][b])[0]).any()


@pytest.mark.parametrize("epoch", [3, 4, None], ids=["atss", "tal", "default_tal"])
@pytest.mark.parametrize("seed", [0, 1])
def test_yolov6_loss_matches_jax(epoch, seed):
    """``yolov6_loss`` at one point on both sides of ``warmup_epoch`` 4
    (JAX's ``lax.cond`` on a traced epoch, the port's Python branch on the
    host integer) and without an epoch."""
    p, nlp = priors(64)
    preds = predictions(64, seed)
    t = targets(64, seed + 7)
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    jepoch = None if epoch is None else jnp.asarray(epoch, jnp.int32)
    jtotal, jparts = jax.jit(lambda a: jax_yolov6.yolov6_loss(
        a, jnp.asarray(p), jt, len(DICTIONARY), nlp, jepoch))(jnp.asarray(preds))
    total, parts = yolov6.yolov6_loss(torch.from_numpy(preds), torch.from_numpy(p),
                                      {k: torch.from_numpy(v) for k, v in t.items()},
                                      len(DICTIONARY), nlp, epoch)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)


def test_the_two_branches_differ():
    """Epochs 3 and 4 give other losses on the same inputs (the switch is
    not a no-op), and epoch 4 equals no epoch."""
    p, nlp = priors(64)
    preds, t = torch.from_numpy(predictions(64, 0)), targets(64, 7)
    t = {k: torch.from_numpy(v) for k, v in t.items()}
    args = (preds, torch.from_numpy(p), t, len(DICTIONARY), nlp)
    l3, l4, ln = (float(yolov6.yolov6_loss(*args, e)[0]) for e in (3, 4, None))
    assert l3 != l4 and l4 == ln


def test_rep_bipan_matches_jax():
    """yolov6_n's neck on four levels (strides 4–32) of a 64² input: eval
    mode in float32, train mode and its running statistics in float64."""
    rng = np.random.RandomState(2)
    chs = (32, 64, 128, 256)
    feats = [rng.randn(B, 64 // s, 64 // s, c).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), chs)]
    jm = jax_yolov6.RepBiPAN(width_mul=0.25, depth_mul=0.33)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=6)
    tm = load_jax_variables(yolov6.RepBiPAN(chs, width_mul=0.25, depth_mul=0.33), variables)
    want = jm.apply(variables, tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        got = tm.eval()([nchw(f) for f in feats])
    assert [g.shape[1] for g in got] == tm.out_channels == [32, 64, 128]
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        want, new_vars = jm.apply(as64, tuple(jnp.asarray(f, jnp.float64) for f in feats),
                                  train=True, mutable=["batch_stats"])
        want = [np.asarray(w) for w in want]
        new_stats = jax.tree_util.tree_map(np.asarray, new_vars["batch_stats"])
    trained = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        got = trained([nchw(f).double() for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w, 1e-9)
    want_stats = load_jax_variables(copy.deepcopy(tm).double(),
                                    {**as64, "batch_stats": new_stats}).state_dict()
    for k, v in trained.state_dict().items():
        if "running" in k:
            assert_close_to_scale(v.numpy(), want_stats[k].numpy(), 1e-9)


# -- the model ------------------------------------------------------------------------
def make_pair(hw=128, seed=3):
    kw = dict(dictionary=DICTIONARY, model_cfg={"CLASS": "src.models.yolov6.YOLOv6",
                                                "TYPE": "yolov6_n"})
    jm = jax_yolov6.YOLOv6(**kw)
    t = {k: jnp.asarray(v) for k, v in targets(hw).items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(images(hw)), t,
                                            mode="train"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(yolov6.YOLOv6(**kw), variables)
    return jm, variables, tm.eval()


@pytest.fixture(scope="module")
def pair128():
    return make_pair()


def test_head_outputs_and_priors_match_jax(pair128):
    jm, variables, tm = pair128
    x = images(128)
    jp, jpriors = jm.apply(variables, jnp.asarray(x), method=lambda m, a: m._forward(a, False))
    with torch.no_grad():
        tp, tpriors, nlp = tm._forward(torch.from_numpy(x))
    assert tp.shape == (B, 336, 4 + len(DICTIONARY)) and nlp == (256, 64, 16)
    assert_close_to_scale(tp.numpy(), jp)
    np.testing.assert_array_equal(tpriors.numpy(), np.asarray(jpriors))


def jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, {k: jnp.asarray(v) for k, v in t.items()}, mode="train",
                                 mutable=["batch_stats"])
    return total, parts


@pytest.mark.parametrize("epoch", [3, 4, None], ids=["atss", "tal", "default_tal"])
def test_train_mode_losses_match_jax(pair128, epoch):
    """The total in float32 within 1e-5, and every term in float64 within
    1e-9: the box term (GIoU weighted by IoU⁶-based soft labels) moves
    1e-4 with the float32 rounding of train-mode BN in a deep random-weight
    network, on either side."""
    jm, variables, tm = pair128
    x, t = images(128), targets(128)
    jt = dict(t) if epoch is None else {**t, "epoch": np.asarray(epoch, np.int32)}
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    if epoch is not None:
        tt["epoch"] = epoch
    jtotal, _ = jax.jit(lambda p: jax_train(jm, variables, p, jnp.asarray(x), jt))(
        variables["params"])
    with torch.no_grad():
        total, _ = copy.deepcopy(tm).train()(torch.from_numpy(x), tt, mode="train")
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        _, jparts = jax_train(jm, as64, as64["params"], jnp.asarray(x, jnp.float64), jt)
        jparts = {k: float(v) for k, v in jparts.items()}
    with torch.no_grad():
        _, parts = copy.deepcopy(tm).double().train()(torch.from_numpy(x).double(), tt,
                                                      mode="train")
    assert set(parts) == set(jparts) | {"loss"} == {"cls_loss", "box_loss", "loss"}
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), jparts[k], rtol=1e-9, err_msg=k)


@pytest.fixture(scope="module")
def jax_grads64(pair128):
    """The JAX model's float64 gradients at the epoch given, one ``jit``
    for both branches (the epoch is a traced argument, JAX's ``lax.cond``
    takes the branch at run time)."""
    jm, variables, _ = pair128
    x, t = images(128), targets(128)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        grad = jax.jit(jax.grad(lambda p, epoch: jax_train(
            jm, as64, p, jnp.asarray(x, jnp.float64), {**t, "epoch": epoch})[0]))

    def at(epoch):
        with jax.enable_x64(True):
            g = grad(as64["params"], jnp.asarray(epoch, jnp.int32))
            return jax.tree_util.tree_map(np.asarray, g)

    return at


@pytest.mark.parametrize("epoch", [3, 4], ids=["atss", "tal"])
def test_train_mode_grads_match_jax(pair128, jax_grads64, epoch):
    """Per leaf, max |Δg| ≤ 5e-3 of max(leaf max |g|, 1e-3 · global max
    |g|), float64 on both sides, in either branch."""
    jm, variables, tm = pair128
    x, t = images(128), targets(128)
    jgrads = jax_grads64(epoch)
    tm = copy.deepcopy(tm).double().train()
    total, _ = tm(torch.from_numpy(x).double(),
                  {**{k: torch.from_numpy(v) for k, v in t.items()}, "epoch": epoch}, mode="train")
    total.backward()
    owners = dict(tm.named_modules())
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        name = ".".join(path[:-1] + (leaf,))
        pairs.append((name, _convert(name, g, tm.state_dict()[name],
                                     owners.get(".".join(path[:-1]))), grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= 5e-3, worst


def test_val_and_infer_predictions_match_jax(pair128):
    """Val losses (epoch 4) within 1e-9 relative; the val predictions
    (un-letterboxed) and the infer predictions through ``batched_nms``:
    labels and valid equal, scores within 1e-6, boxes within 1e-4 pixels.
    Both sides in float64: with random statistics in eval-mode BN this
    network's outputs reach 1e2 (class logits far beyond, every score
    1.0), and float32 rounding moves a box by up to 3e-4 of its scale."""
    jm, variables, tm = pair128
    x, t = images(128, seed=1), targets(128)
    t["boxes"] = t["boxes"].astype(np.float64)
    t["pads"] = np.array([[0, 16], [8, 0]], np.float64)
    t["scales"] = np.array([[0.5, 0.5], [0.75, 0.75]], np.float64)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        jt = {**{k: jnp.asarray(v) for k, v in t.items()}, "epoch": jnp.asarray(4, jnp.int32)}
        jl, jd = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
            as64, jnp.asarray(x, jnp.float64), jt)
        ji = jax.jit(lambda v, a: jm.apply(v, a, mode="infer"))(as64, jnp.asarray(x, jnp.float64))
        jl, jd, ji = jax.tree_util.tree_map(np.asarray, (jl, jd, ji))
    tm = copy.deepcopy(tm).double()
    with torch.no_grad():
        tl, td = tm(torch.from_numpy(x).double(),
                    {**{k: torch.from_numpy(v) for k, v in t.items()}, "epoch": 4}, mode="val")
        ti = tm(torch.from_numpy(x).double(), mode="infer")
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-9, err_msg=k)
    for got, want in ((td, jd), (ti, ji)):
        assert got["boxes"].shape == (B, 300, 4) and want["valid"].sum() > 100
        np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
        np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("size", "ntsml")
def test_sizes_build_the_jax_model(size):
    """``TYPE`` yolov6_{n,t,s,m,l}: as many parameters and BN statistics as
    the JAX model of that size (shapes only, at 64²)."""
    kw = dict(dictionary=DICTIONARY, model_cfg={"TYPE": f"yolov6_{size}"})
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jax_yolov6.YOLOv6(**kw).init(jax.random.PRNGKey(0), x))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = yolov6.YOLOv6(**kw)
    got = sum(v.numel() for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked"))
    assert got == want
    assert m.neck.out_channels == [int(c * yolov6.SIZE_CFG[size][1]) for c in (128, 256, 512)]
