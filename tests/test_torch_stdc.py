"""STDC and PP-LiteSeg in the port (``models/light_seg.py``, and
``light_seg2.PPLiteSeg`` on ``STDCNet``) against the JAX package on the
CPU, weights carried by ``load_jax_variables`` strictly; also the helpers
the other self-contained segmenters' tests share.

Tolerances: ``detail_target`` bit for bit; the detail loss within 1e-6
relative; eval-mode logits at the input size within 1e-4 of their largest
|value| in float32, val losses within 1e-5 relative and the argmax equal;
the train-mode losses within 1e-5 relative in float32 at B = 2 and
per-leaf gradients within 5e-3 of the leaf's largest in float64 on both
sides (BN over the 1×1 global context and near-ties); the classifier
within 1e-4.  Dropout is off on both sides where they train.
"""
import contextlib
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.models import light_seg as jax_light_seg
from cvpytorch_tpu.models.light_seg2 import PPLiteSeg as JaxPPLiteSeg
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.infer import build_model
from cvpytorch_tpu_torch.models.light_seg import STDCNet, detail_loss, detail_target
from cvpytorch_tpu_torch.registry import BACKBONES, MODELS
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables, port_name
from tests.test_torch_rcnn_ops import fill_tree, init_tree, nchw
from tests.test_torch_seg_models import DICTIONARY, batch, rel_err
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)


# -- helpers shared by the self-contained segmenters' tests ------------------
def make_model_pair(jax_cls, cfg, h, w, seed=3):
    """The JAX model and the port's model of the same registered name, the
    port's weights carried strictly from a seeded tree."""
    jm = jax_cls(dictionary=DICTIONARY, model_cfg=JaxConfig(cfg))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w), jnp.int32),
        mode="val"))
    variables = fill_tree(shapes, seed)
    port_cls = MODELS.get(jax_cls.__name__)
    tm = load_jax_variables(port_cls(dictionary=DICTIONARY, model_cfg=CommonConfiguration(cfg)),
                            variables)
    return jm, variables, tm


@contextlib.contextmanager
def logits_for_argmax():
    """Inside, ``jnp.argmax`` of a 4-D array over its last axis returns the
    array: a JAX model's ``mode="infer"`` gives the NHWC logits its argmax
    takes (max_pool_argmax's 5-D taps still get the argmax)."""
    orig = jnp.argmax

    def passthrough(a, axis=None, **kw):
        return a if (jnp.ndim(a) == 4 and axis == -1) else orig(a, axis=axis, **kw)

    jnp.argmax = passthrough
    try:
        yield
    finally:
        jnp.argmax = orig


def jax_logits(jm, variables, x):
    with logits_for_argmax():
        return np.asarray(jax.jit(lambda v, a: jm.apply(v, a, mode="infer"))(
            variables, jnp.asarray(x)))


def check_forward(jm, variables, tm, h, w, tol=1e-4, B=2):
    """Eval mode: the logits at the input size within ``tol`` of their
    largest |value|, val losses within 1e-5 relative, the argmax equal."""
    x, t = batch(h, w, seed=1, B=B)
    want = jax_logits(jm, variables, x)
    jl, jpred = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
        variables, jnp.asarray(x), jnp.asarray(t))
    tm.eval()
    with torch.no_grad():
        got = tm.logits(torch.from_numpy(x))
        tl, tpred = tm(torch.from_numpy(x), torch.from_numpy(t), mode="val")
        infer = tm(torch.from_numpy(x), mode="infer")
    assert got.dtype == torch.float32 and got.shape == (B, len(DICTIONARY), h, w)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < tol
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(infer.numpy(), np.asarray(jpred))
    return got


@contextlib.contextmanager
def no_dropout(tm):
    """JAX's ``nn.Dropout`` an identity and the port's dropouts at p = 0."""
    orig = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    saved = {m: m.p for m in tm.modules() if isinstance(m, torch.nn.modules.dropout._DropoutNd)}
    for m in saved:
        m.p = 0.0
    try:
        yield
    finally:
        fnn.Dropout.__call__ = orig
        for m, p in saved.items():
            m.p = p


def _jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, jnp.asarray(t), mode="train", mutable=["batch_stats"])
    return total, parts


def check_train(jm, variables, tm, h, w, B=2, grad_tol=5e-3, seed=2, float32_losses=True):
    """Train mode on ``B`` images, dropout off: every loss within 1e-5
    relative in float32 (with ``float32_losses``; always within 1e-6 in
    float64); per-leaf gradients within ``grad_tol`` of the leaf's largest
    (or 1e-3 of the largest of all) in float64 on both sides, every port
    parameter matched by one JAX leaf."""
    x, t = batch(h, w, seed=seed, B=B)

    def compare(parts, jparts, rtol):
        assert set(parts) == set(jparts)
        for k in jparts:
            np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=rtol, err_msg=k)

    with no_dropout(tm):
        if float32_losses:
            _, jparts = jax.jit(lambda p: _jax_train(jm, variables, p, jnp.asarray(x), t))(
                variables["params"])
            with torch.no_grad():
                _, parts = copy.deepcopy(tm).train()(torch.from_numpy(x), torch.from_numpy(t),
                                                     mode="train")
            compare(parts, jparts, 1e-5)

        as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        with jax.enable_x64(True):
            (_, jparts), jgrads = jax.jit(jax.value_and_grad(lambda p: _jax_train(
                jm, as64, p, jnp.asarray(x, jnp.float64), t), has_aux=True))(as64["params"])
            jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        t64 = copy.deepcopy(tm).double().train()
        total, parts = t64(torch.from_numpy(x).double(), torch.from_numpy(t), mode="train")
        total.backward()
    compare(parts, jparts, 1e-6)
    owners = dict(t64.named_modules())
    params = dict(t64.named_parameters())
    pairs = []
    for path, g in _flatten(jgrads):
        name = port_name("params", path, params)
        pairs.append((name, _convert(name, g, params[name], owners.get(".".join(path[:-1]))),
                      params[name].grad.numpy()))
    assert sorted(n for n, _, _ in pairs) == sorted(params)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= grad_tol, worst


# -- the detail target and loss ----------------------------------------------
def labels(B, h, w, seed):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 19, (B, h, w)).astype(np.int32)
    t[:, ::5] = np.repeat(t[:, ::5, :1], w, 2)  # flat runs: edges and non-edges
    t[0, :3] = 255
    return t


@pytest.mark.parametrize("hw", [(37, 53), (64, 128)])
def test_detail_target_equals_jax_bit_for_bit(hw):
    """At 37×53 the strides 2 and 4 do not divide (19×27 and 10×14 maps
    upsampled by half-pixel nearest)."""
    t = labels(2, *hw, seed=sum(hw))
    want = np.asarray(jax_light_seg.detail_target(jnp.asarray(t)))
    got = detail_target(torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95


def test_detail_target_upsamples_with_half_pixel_centres():
    """torch's "nearest" samples ⌊i·in/out⌋: on the 37×53 map it would
    give another target."""
    t = torch.from_numpy(labels(2, 37, 53, seed=90))
    m = torch.where(t == 255, 0, t).float()[:, None]
    k = torch.tensor(jax_light_seg._LAPLACIAN.tolist()).reshape(1, 1, 3, 3)
    edge = torch.clamp(F.conv2d(m, k, stride=4, padding=1), min=0)
    floor_up = F.interpolate(edge, size=(37, 53), mode="nearest")
    want = jax.image.resize(jnp.asarray(edge.numpy()), (2, 1, 37, 53), "nearest")
    assert not np.array_equal(floor_up.numpy(), np.asarray(want))


def test_detail_loss_matches_jax():
    t = labels(2, 37, 53, seed=7)
    logits = np.random.RandomState(8).randn(2, 37, 53).astype(np.float32) * 3
    jb, jd = jax_light_seg.detail_loss(jnp.asarray(logits), jnp.asarray(t))
    bce, dice = detail_loss(torch.from_numpy(logits), torch.from_numpy(t))
    np.testing.assert_allclose(float(bce), float(jb), rtol=1e-6)
    np.testing.assert_allclose(float(dice), float(jd), rtol=1e-6)
    want = optax.sigmoid_binary_cross_entropy(jnp.asarray(logits),
                                              jax_light_seg.detail_target(jnp.asarray(t)))
    np.testing.assert_allclose(float(bce), float(want.mean()), rtol=1e-6)


# -- STDC and PP-LiteSeg -------------------------------------------------------
STDC = {"BACKBONE": {"name": "STDCNet", "subtype": "stdc1"}}
CASES = {"stdc": (jax_light_seg.STDC, STDC), "ppliteseg": (JaxPPLiteSeg, {})}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jax_cls, cfg = CASES[request.param]
    return make_model_pair(jax_cls, cfg, 64, 128)


def test_forward_matches_jax(pair):
    check_forward(*pair, 64, 128)


def test_train_losses_and_grads_match_jax(pair):
    """B = 2: at B = 1 the global context's BN gives 0; float64 grads."""
    check_train(*pair, 64, 128, B=2)


def test_stdcnet_classifier_matches_jax():
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    jm = jax_light_seg.STDCNet(classifier=True, num_classes=9)
    variables = init_tree(jm, jnp.asarray(x), seed=6)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(STDCNet(classifier=True, num_classes=9), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 9)
    assert rel_err(got.numpy(), want) < 1e-4


def test_stdc2_config_builds_stdcnet_1_as_jax_does(tmp_path):
    """``conf/cityscapes_stdc2.yml`` names ``subtype: stdc2``, but JAX's
    ``STDC`` builds ``STDCNet(subtype=self.subtype)`` (default "stdc1"):
    5.830 M parameters on both sides, where STDCNet-2 would have more."""
    cfg = CommonConfiguration.from_file("conf/cityscapes_stdc2.yml")
    assert cfg.USE_MODEL.BACKBONE.subtype == "stdc2"
    tm = build_model(cfg, DICTIONARY)
    n_port = sum(p.numel() for p in tm.parameters())
    jm = jax_light_seg.STDC(dictionary=DICTIONARY, model_cfg=JaxConfig(dict(cfg.USE_MODEL.data)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_port == n_jax and round(n_port / 1e6, 3) == 5.830
    assert not hasattr(tm.backbone, "stage4_4")
    assert sum(p.numel() for p in STDCNet("stdc2").parameters()) > 1.5 * sum(
        p.numel() for p in STDCNet("stdc1").parameters())


def test_names_resolve():
    from cvpytorch_tpu_torch.models import light_seg, light_seg2

    assert BACKBONES.get("STDCNet") is light_seg.STDCNet
    assert MODELS.get("STDC") is light_seg.STDC
    assert MODELS.get("PPLiteSeg") is light_seg2.PPLiteSeg
