"""The port's GiraffeNeck, GFocalHeadV2 with its GFLv2 loss (DGQP, QFL in
probability space, SimOTA with soft-label costs) and AIRDet against the
JAX package on the CPU, with one set of weights carried across by
``load_jax_variables``; GiraffeDet in ``test_torch_giraffedet.py``.

Tolerances: the neck and head within 1e-5 / 1e-4 of their largest output
(float32, eval mode), the neck's train mode 1e-9 (float64); the loss
terms within 1e-9 relative and SimOTA's ``matched_gt`` equal (float64,
constructed ties of gts and of predictions); the head's train mode under
the loss: every gradient leaf within 1e-6 of its largest value (float64);
AIRDet's train-mode losses within 1e-9 (float64: the full-detector
gradients of this family are held on GiraffeDet, whose float64 backward
XLA compiles in half the time).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import airdet as jax_airdet
from cvpytorch_tpu.models.assigners.ota_assigner import simota_assign as jax_simota
from cvpytorch_tpu.models.heads import gflv2_head as jax_gflv2
from cvpytorch_tpu.models.heads.nanodet_head import center_priors as jax_center_priors
from cvpytorch_tpu.models.necks import giraffe_neck as jax_giraffe_neck
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import airdet
from cvpytorch_tpu_torch.models.assigners.ota_assigner import simota_assign
from cvpytorch_tpu_torch.models.heads import gflv2_head
from cvpytorch_tpu_torch.models.necks.giraffe_neck import GiraffeNeck
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables, port_name
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, as64, check_train_losses_and_grads, images,
                                    make_pair, targets, torch_targets,
                                    trains_validates_and_serves)

C = len(DICTIONARY)
HW = 64
REG_MAX = 14


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def assert_grads_match(jgrads, tm, tol=1e-6):
    """Every leaf of the JAX gradient tree against the port's ``.grad``:
    max |Δg| within ``tol`` of max(leaf max |g|, 1e-3 · global max |g|)."""
    owners, state = dict(tm.named_modules()), tm.state_dict()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        name = port_name("params", path, grads)
        pairs.append((_convert(name, g, state[name], owners.get(".".join(path[:-1]))),
                      grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, g in pairs)
    assert max(float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax))
               for j, g in pairs) <= tol


def test_giraffe_neck_matches_jax():
    """AIRDet-s's widths on C3–C5 of a 64² input: eval mode in float32,
    train mode and the running statistics in float64."""
    rng = np.random.RandomState(0)
    chs, fpn = (128, 256, 512), (96, 160, 384)
    feats = [rng.randn(B, s, s, c).astype(np.float32) for s, c in zip((8, 4, 2), chs)]
    jm = jax_giraffe_neck.GiraffeNeck(fpn_channels=fpn, out_channels=fpn)
    jf = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jf, seed=1)
    tm = load_jax_variables(GiraffeNeck(chs, fpn, fpn), variables).eval()
    want = jax.jit(jm.apply)(variables, jf)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-5)
    v64 = as64(variables)
    with jax.enable_x64(True):
        want, new = jax.jit(lambda v, f: jm.apply(v, f, True, mutable=["batch_stats"]))(
            v64, tuple(jnp.asarray(f, jnp.float64) for f in feats))
        want = [np.asarray(w) for w in want]
        new = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    trained = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        got = trained([nchw(f).double() for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-9)
    stats = load_jax_variables(copy.deepcopy(tm).double(), {**v64, "batch_stats": new})
    for k, v in trained.state_dict().items():
        if "running" in k:
            assert_close_to_scale(v.numpy(), stats.state_dict()[k].numpy(), 1e-9)


@pytest.mark.parametrize("groups", [2, 1])
def test_gflv2_head_matches_jax(groups):
    """Grouped (AIRDet) and plain (GiraffeDet) towers, the scalar ``scale``
    param, DGQP: class probabilities and regression logits, eval mode."""
    rng = np.random.RandomState(2)
    chs = (16, 32, 64)
    feats = [rng.randn(B, s, s, c).astype(np.float32) for s, c in zip((8, 4, 2), chs)]
    jm = jax_gflv2.GFocalHeadV2(num_classes=C, feat_channels=chs, conv_groups=groups,
                                stacked_convs=2)
    jf = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jf, seed=3)
    variables["params"]["scale1"]["scale"] = np.float32(1.7)
    tm = load_jax_variables(gflv2_head.GFocalHeadV2(C, chs, 2, conv_groups=groups), variables)
    jc, jr, jp = jax.jit(jm.apply)(variables, jf)
    with torch.no_grad():
        tc, tr, tp = tm.eval()([nchw(f) for f in feats])
    assert tm.cls0_0.conv.groups == groups and float(tm.scale1.weight) == np.float32(1.7)
    assert_close_to_scale(tc.numpy(), jc)
    assert_close_to_scale(tr.numpy(), jr)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def loss_inputs(seed):
    """64² at strides 8–32 (84 priors), in float64: class probabilities
    and regression logits; ties constructed as in the SimOTA tests: image
    0's gt 3 repeats gt 1, priors 20 and 21 share one prediction."""
    priors = np.array(jax_center_priors([(8, 8), (4, 4), (2, 2)], (8, 16, 32)), np.float64)
    P = priors.shape[0]
    rng = np.random.RandomState(seed)
    cls = 1 / (1 + np.exp(-rng.randn(B, P, C) * 2))
    reg = rng.randn(B, P, 4, REG_MAX + 1) + np.linspace(1, -1, REG_MAX + 1)
    cls[:, 21], reg[:, 21] = cls[:, 20], reg[:, 20]
    t = targets(HW, seed + 5)
    t["boxes"] = t["boxes"].astype(np.float64)
    t["boxes"][0, 3], t["labels"][0, 3] = t["boxes"][0, 1], t["labels"][0, 1]
    return cls, reg, priors, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gflv2_loss_and_assignment_match_jax_float64(seed):
    cls, reg, priors, t = loss_inputs(seed)
    with jax.enable_x64(True):
        jt = {k: jnp.asarray(v) for k, v in t.items()}
        _, want = jax.jit(lambda c, r, p: jax_gflv2.gflv2_loss(c, r, p, jt, C, REG_MAX))(
            jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(priors))
        decoded = jax_gflv2.gflv2_decode(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(priors))
        jmatched = jax.jit(jax.vmap(lambda s, d, gb, gl, gv: jax_simota(
            s, jnp.ones(priors.shape[0]), jnp.asarray(priors), d, gb, gl, gv, topk=10,
            center_radius=2.5, soft_label=True)["matched_gt"]))(
            jnp.asarray(cls), decoded, jt["boxes"], jt["labels"], jt["valid"])
        want = {k: float(v) for k, v in want.items()}
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
    tc, tr, tp = map(torch.from_numpy, (cls, reg, priors))
    _, got = gflv2_head.gflv2_loss(tc, tr, tp, tt, C, REG_MAX)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)
    matched = simota_assign(tc, torch.ones(B, tp.shape[0], dtype=torch.float64), tp,
                            gflv2_head.gflv2_decode(tc, tr, tp), tt["boxes"], tt["labels"],
                            tt["valid"], topk=10, center_radius=2.5, soft_label=True)["matched_gt"]
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jmatched))
    assert (matched >= 0).sum() > 3 and not (matched[0] == 3).any()


def test_qfl_probability_matches_jax():
    rng = np.random.RandomState(4)
    probs = rng.rand(40, C) * 0.999
    probs[0, 0], probs[1, 1] = 0.0, 1.0  # clipped to [1e-6, 1 − 1e-6]
    labels = rng.randint(0, C + 1, 40)
    scores = rng.rand(40)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax_gflv2.qfl_probability)(
            *map(jnp.asarray, (probs, labels, scores))))
    got = gflv2_head.qfl_probability(*map(torch.from_numpy, (probs, labels, scores)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_head_train_mode_and_loss_grads_match_jax():
    """AIRDet's grouped towers (2 groups), the DGQP's sorted top 4 and the
    loss, train mode in float64: the loss terms within 1e-9 and every
    gradient leaf of the head within 1e-6."""
    rng = np.random.RandomState(5)
    chs = (16, 32, 64)
    feats = [rng.randn(B, s, s, c) for s, c in zip((8, 4, 2), chs)]
    jm = jax_gflv2.GFocalHeadV2(num_classes=C, feat_channels=chs, conv_groups=2,
                                stacked_convs=2)
    variables = as64(init_tree(jm, tuple(jnp.asarray(f, jnp.float32) for f in feats), seed=6))
    t = {k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v
         for k, v in targets(HW, 7).items()}

    def loss(p):
        (cls, reg, priors), _ = jm.apply({**variables, "params": p},
                                         tuple(jnp.asarray(f) for f in feats), True,
                                         mutable=["batch_stats"])
        return jax_gflv2.gflv2_loss(cls, reg, priors, {k: jnp.asarray(v) for k, v in t.items()},
                                    C, REG_MAX)

    with jax.enable_x64(True):
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
        want = {k: float(v) for k, v in want.items()}
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = load_jax_variables(gflv2_head.GFocalHeadV2(C, chs, 2, conv_groups=2).double(),
                            variables).train()
    cls, reg, priors = tm([nchw(f) for f in feats])
    total, got = gflv2_head.gflv2_loss(cls, reg, priors.double(), torch_targets(t), C, REG_MAX)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)
    total.backward()
    assert_grads_match(jgrads, tm)


# -- AIRDet -------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_airdet.AIRDet, airdet.AIRDet, {"TYPE": "airdet_nano"}, HW)


def test_airdet_head_outputs_match_jax(pair):
    jm, variables, tm = pair
    x = images(HW)
    jc, jr, jp = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._outs(
        i, tr)))(variables, jnp.asarray(x))
    with torch.no_grad():
        tc, tr, tp = tm._outs(torch.from_numpy(x))
    assert tc.shape == (B, 84, C) and tr.shape == (B, 84, 4, REG_MAX + 1)
    assert_close_to_scale(tc.numpy(), jc)
    assert_close_to_scale(tr.numpy(), jr)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_airdet_train_losses_match_jax(pair):
    jm, variables, tm = pair
    check_train_losses_and_grads(jm, variables, tm, images(HW), targets(HW),
                                 ("qfl_loss", "bbox_loss", "dfl_loss"), grads=False)


def test_airdet_s_builds_the_jax_model():
    """As many parameters and BN statistics as the JAX model (shapes only,
    at 64²); neck (96, 160, 384), towers of 2 groups."""
    kw = dict(dictionary=DICTIONARY, model_cfg={"TYPE": "airdet_s"})
    shapes = jax.eval_shape(lambda: jax_airdet.AIRDet(**kw).init(jax.random.PRNGKey(0),
                                                                  jnp.zeros((1, 64, 64, 3))))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = airdet.AIRDet(**kw)
    got = sum(v.numel() for k, v in m.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == want
    assert m.neck.out_channels == (96, 160, 384) and m.head.cls2_3.conv.groups == 2


def test_airdet_config_trains_validates_and_serves(tmp_path):
    cfg = CommonConfiguration.from_file("conf/coco_airdet.yml")
    with torch.device("meta"):
        assert type(infer.build_model(cfg, DICTIONARY)) is airdet.AIRDet
    trains_validates_and_serves(tmp_path, "coco_airdet")
