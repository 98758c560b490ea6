"""SegNeXt in the port (``MSCAN`` and ``LightHamHead`` with its NMF
``Hamburger``) against the JAX package on the CPU, weights carried by
``load_jax_variables``.

Tolerances: the NMF bases equal ``jax.random.uniform(PRNGKey(0), …)``
bit for bit before normalisation; ``nmf2d`` and the heads within 1e-4 of
the largest output in float32, the NMF's gradients within 1e-6 of the
largest in float64; MSCAN-T + LightHamHead eval-mode features and logits
within 1e-4 of their largest value in float32, val losses within 1e-5
relative and the argmax equal; the train-mode loss within 1e-5 relative
in float32 and per-leaf gradients within 5e-3 of the leaf's largest value
in float64 on both sides (as the other model tests hold them).  DropPath
and dropout are 0 where both sides train.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.models.backbones.seg_transformers import MSCAN as JaxMSCAN
from cvpytorch_tpu.models.heads.seg_heads import resize_bilinear as jax_resize
from cvpytorch_tpu.models.heads.seg_heads_extra import LightHamHead as JaxLightHamHead
from cvpytorch_tpu.models.heads.seg_heads_extra import _default_bases as jax_default_bases
from cvpytorch_tpu.models.heads.seg_heads_extra import nmf2d as jax_nmf2d
from cvpytorch_tpu.models.segmentor import EncoderDecoder as JaxEncoderDecoder
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models.backbones.seg_transformers import MSCAN
from cvpytorch_tpu_torch.models.heads.seg_heads_extra import (
    Hamburger, LightHamHead, default_bases, nmf2d, prng_uniform)
from cvpytorch_tpu_torch.models.segmentor import EncoderDecoder, feature_channels
from cvpytorch_tpu_torch.registry import BACKBONES, HEADS, MODELS
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables, port_name
from tests.test_torch_rcnn_ops import fill_tree, init_tree, nchw
from tests.test_torch_seg_models import batch, rel_err
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"class{i}": 1.0 + 0.05 * i} for i in range(19))
SEGNEXT = {"BACKBONE": {"name": "MSCAN", "subtype": "mscan_t", "out_stages": [2, 3, 4],
                        "drop_path_rate": 0.0},
           "HEAD": {"name": "LightHamHead", "channels": 64, "ham_channels": 64,
                    "dropout": 0.0}}


def make_pair(cfg, h, w, seed=3):
    """The JAX and port ``EncoderDecoder`` of ``cfg``, the port's weights
    carried from a seeded tree."""
    jm = JaxEncoderDecoder(dictionary=DICTIONARY, model_cfg=JaxConfig(cfg))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w), jnp.int32),
        mode="train"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(
        EncoderDecoder(dictionary=DICTIONARY, model_cfg=CommonConfiguration(cfg)), variables)
    return jm, variables, tm


def jax_eval(jm, variables, x, t):
    """The backbone's features, the logits at the input size and the val
    losses and argmax, in one jitted call."""
    def run(m, a, b):
        feats = m.backbone(a, train=False)
        return feats, jax_resize(m.head(feats, train=False), a.shape[1:3]), m(a, b, mode="val")

    return jax.jit(lambda v, a, b: jm.apply(v, a, b, method=run))(
        variables, jnp.asarray(x), jnp.asarray(t))


def check_eval_forward(jm, variables, tm, h, w, tol=1e-4):
    """Eval mode: features and logits within ``tol`` of their largest
    value, val losses within 1e-5 relative, the argmax equal."""
    x, t = batch(h, w, seed=1)
    jfeats, want, (jl, jpred) = jax_eval(jm, variables, x, t)
    tm.eval()
    with torch.no_grad():
        images = torch.from_numpy(x)
        feats = tm.backbone(images.permute(0, 3, 1, 2))
        got = tm._logits(tm.head, feats, (h, w))
        tl, tpred = tm(images, torch.from_numpy(t), mode="val")
    assert [f.shape[1] for f in feats] == feature_channels(tm.backbone)
    for f, jf in zip(feats, jfeats):
        assert rel_err(f.permute(0, 2, 3, 1).numpy(), jf) < tol
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < tol
    np.testing.assert_allclose(float(tl["seg_loss"]), float(jl["seg_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def _jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, jnp.asarray(t), mode="train", mutable=["batch_stats"])
    return total, parts


def check_train_loss_and_grads(jm, variables, tm, h, w, B=1, grad_tol=5e-3):
    """Train mode on ``B`` images: the loss within 1e-5 relative in
    float32; per-leaf gradients within ``grad_tol`` of the leaf's largest
    value in float64 on both sides, every port parameter matched by a JAX
    leaf.  (XLA runs float64 depthwise convolutions slowly on the CPU,
    ~3 s for a 3×3 over 512 channels at 16×32: keep the inputs small.)"""
    x, t = batch(h, w, seed=2, B=B)
    jtotal, _ = jax.jit(lambda p: _jax_train(jm, variables, p, jnp.asarray(x), t))(
        variables["params"])
    with torch.no_grad():
        total, parts = copy.deepcopy(tm).train()(torch.from_numpy(x), torch.from_numpy(t),
                                                 mode="train")
    assert set(parts) == {"seg_loss"}
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)

    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        jgrads = jax.jit(jax.grad(lambda p: _jax_train(
            jm, as64, p, jnp.asarray(x, jnp.float64), t)[0]))(as64["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = copy.deepcopy(tm).double().train()
    total, _ = tm(torch.from_numpy(x).double(), torch.from_numpy(t), mode="train")
    total.backward()
    owners = dict(tm.named_modules())
    params = dict(tm.named_parameters())
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


# -- the NMF bases: JAX's threefry draw in numpy -----------------------------
@pytest.mark.parametrize("shape", [(1, 256, 64), (8, 256, 64), (2, 32, 8), (3, 5)])
def test_bases_draw_equals_jax_bit_for_bit(shape):
    """float32: ``jax.random.uniform(PRNGKey(0), shape)``'s bits; float64
    (JAX with 64-bit floats, what the float64 gradient checks run) too."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))
    got = prng_uniform(shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with jax.enable_x64(True):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))
    assert want.dtype == np.float64
    np.testing.assert_array_equal(prng_uniform(shape, np.float64).view(np.uint64),
                                  want.view(np.uint64))


def test_bases_normalise_as_jax_and_a_batch_is_a_prefix():
    """The normalised bases within 1e-6 of JAX's ``_default_bases``; the
    bases of B = 1 are the first row of those of B = 8, so a sample's
    result does not depend on its batch; the head draws once for the
    largest batch seen and slices it."""
    want = np.asarray(jax_default_bases(8, 256, 64))
    got = default_bases(8, 256, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(default_bases(1, 256, 64), got[:1])
    ham = Hamburger(64, 16)
    big = ham.bases(4, 64, "cpu", torch.float32)
    assert ham.bases(2, 64, "cpu", torch.float32).data_ptr() == big.data_ptr()
    np.testing.assert_array_equal(big.numpy(), default_bases(4, 64, 16))


@pytest.mark.parametrize("steps", [6, 7])
def test_nmf2d_matches_jax(steps):
    """6 rounds (train) and 7 (eval): the reconstruction within 1e-4 of
    its largest value in float32; the gradients of a weighted sum with
    respect to x and the bases within 1e-6 of their largest in float64."""
    rng = np.random.RandomState(steps)
    x = rng.rand(2, 32, 40).astype(np.float32)
    bases = default_bases(2, 32, 8)
    w = rng.randn(2, 32, 40)
    want = jax_nmf2d(jnp.asarray(x), jnp.asarray(bases), steps)
    got = nmf2d(torch.from_numpy(x), torch.from_numpy(bases), steps)
    assert rel_err(got.numpy(), want) < 1e-4
    with jax.enable_x64(True):
        jg = jax.grad(lambda a, b: (jax_nmf2d(a, b, steps) * w).sum(), argnums=(0, 1))(
            jnp.asarray(x, jnp.float64), jnp.asarray(bases, jnp.float64))
    tx = torch.from_numpy(x).double().requires_grad_()
    tb = torch.from_numpy(bases).double().requires_grad_()
    (nmf2d(tx, tb, steps) * torch.from_numpy(w)).sum().backward()
    assert rel_err(tx.grad.numpy(), jg[0]) < 1e-6
    assert rel_err(tb.grad.numpy(), jg[1]) < 1e-6


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_light_ham_head_matches_jax(train):
    """Three levels into ``ham_channels`` 64 (GN 32): the logits within
    1e-4 of their largest value, eval (7 NMF rounds) and train mode (6;
    GroupNorm has no running statistics, dropout 0)."""
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, 16 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((16, 24, 32))]
    kw = dict(num_classes=7, channels=64, ham_channels=64, nmf_rank=8, dropout=0.0)
    jm = JaxLightHamHead(**kw)
    jf = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jf, seed=5)
    want = jm.apply(variables, jf, train=train)
    tm = load_jax_variables(LightHamHead([16, 24, 32], **kw), variables).train(train)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert got.shape == (2, 7, 16, 32)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4


# -- MSCAN-T + LightHamHead ---------------------------------------------------
def test_segnext_t_forward_matches_jax():
    """MSCAN-T (stages 2–4) + LightHamHead at 64×128, eval mode."""
    jm, variables, tm = make_pair(SEGNEXT, 64, 128)
    assert feature_channels(tm.backbone) == [64, 160, 256]
    check_eval_forward(jm, variables, tm, 64, 128)


def test_segnext_t_train_loss_and_grads_match_jax():
    """One train-mode forward (6 NMF rounds, BN on the batch's
    statistics) and its gradients, the layer scales ``ls1``/``ls2``
    included."""
    jm, variables, tm = make_pair(SEGNEXT, 64, 128, seed=4)
    check_train_loss_and_grads(jm, variables, tm, 64, 128)


def test_mscan_classifier_matches_jax():
    """``classifier=True``: the Dense ``fc`` on the last stage's mean,
    within 1e-4 of the largest logit."""
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    kw = dict(subtype="mscan_t", classifier=True, num_classes=11)
    jm = JaxMSCAN(**kw)
    variables = init_tree(jm, jnp.asarray(x), seed=8)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(MSCAN(**kw), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 11)
    assert rel_err(got.numpy(), want) < 1e-4


def test_mscan_tree_loads_strictly_layer_scales_included():
    """The block's bare ``ls1``/``ls2`` carry to the parameters of the same
    name; one left out of the tree, one of the wrong shape, or a bare
    leaf the port does not hold raises."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, init_tree(JaxMSCAN(), jnp.asarray(x), seed=1))
    tm = load_jax_variables(MSCAN(), variables)
    np.testing.assert_array_equal(tm.stage3_block4.ls2.detach().numpy(),
                                  variables["params"]["stage3_block4"]["ls2"])
    missing = copy.deepcopy(variables)
    del missing["params"]["stage1_block0"]["ls1"]
    with pytest.raises(KeyError, match="stage1_block0.ls1"):
        load_jax_variables(MSCAN(), missing)
    wrong = copy.deepcopy(variables)
    wrong["params"]["stage2_block1"]["ls2"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="shape mismatch at stage2_block1.ls2"):
        load_jax_variables(MSCAN(), wrong)
    extra = copy.deepcopy(variables)
    extra["params"]["stage2_block1"]["ls3"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="stage2_block1/ls3"):
        load_jax_variables(MSCAN(), extra)


def test_mscan_specs_and_names_resolve():
    """The registry names and aliases; each subtype's widths and depths;
    DropPath rates 0.1·b/(blocks − 1)."""
    for alias in ("MSCAN", "mscan"):
        assert BACKBONES.get(alias) is MSCAN
    assert HEADS.get("LightHamHead") is LightHamHead
    assert MODELS.get("SegNeXt") is EncoderDecoder
    for sub, blocks, dims in (("mscan_t", 13, [32, 64, 160, 256]),
                              ("mscan_s", 10, [64, 128, 320, 512]),
                              ("mscan_b", 21, [64, 128, 320, 512]),
                              ("mscan_l", 38, [64, 128, 320, 512])):
        m = MSCAN(sub)
        assert sum(m.depths) == blocks and m.channels == dims
    m = MSCAN("mscan_t")
    rates = [getattr(m, f"stage{si + 1}_block{j}").dp1.rate
             for si, d in enumerate(m.depths) for j in range(d)]
    np.testing.assert_allclose(rates, [0.1 * b / 12 for b in range(13)])
    assert m.out_ln0.eps == 1e-5
