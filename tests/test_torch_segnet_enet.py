"""SegNet and ENet in the port (``models/segnet_enet.py``, on
``ops/pool.py``) and the port's ``bce_2d`` against the JAX package on the
CPU, weights carried by ``load_jax_variables`` strictly.

Tolerances: the transposed ``_CBA`` within 1e-5 of its largest output;
``bce_2d`` within 1e-6 relative, its float64 gradient within 1e-12; the
models as in ``tests/test_torch_stdc.py`` (eval logits 1e-4 of their
largest |value| in float32, losses 1e-5 relative, float64 per-leaf
gradients 5e-3), at 64×128 and at 72×136, where pooled maps are odd
(SegNet's 9×17 pools to 4×8 and unpools back; ENet's last level is
9×17).  ENet's dropout is off on both sides where they train.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import segnet_enet as jax_segnet_enet
from cvpytorch_tpu.models.losses.seg_loss import bce_2d as jax_bce_2d
from cvpytorch_tpu_torch.models.losses.seg_loss import bce_2d
from cvpytorch_tpu_torch.models.segnet_enet import ConvTranspose2x, ENet, SegNet, _CBA
from cvpytorch_tpu_torch.registry import MODELS
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree, nchw, nhwc
from tests.test_torch_seg_models import rel_err
from tests.test_torch_stdc import check_forward, check_train, make_model_pair
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

# name: (JAX class, h, w, weight seed).  A max pool whose two largest taps
# lie within float32 rounding of each other can take another index on
# each side and move a whole unpooled value: SegNet at 72×136 has such a
# window at weight seeds 3 and 4, none at seed 5 (ROADMAP's
# near-equal-scores trap)
CASES = {"segnet_64x128": (jax_segnet_enet.SegNet, 64, 128, 3),
         "segnet_72x136": (jax_segnet_enet.SegNet, 72, 136, 5),
         "enet_64x128": (jax_segnet_enet.ENet, 64, 128, 3),
         "enet_72x136": (jax_segnet_enet.ENet, 72, 136, 3)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jax_cls, h, w, seed = CASES[request.param]
    return make_model_pair(jax_cls, {}, h, w, seed=seed), h, w


def test_forward_matches_jax(case):
    (jm, variables, tm), h, w = case
    check_forward(jm, variables, tm, h, w)


def duplicates(idx):
    flat = idx.reshape(idx.shape[0] * idx.shape[1], -1)
    return sum(len(row) - len(torch.unique(row)) for row in flat)


def test_enet_unpools_duplicate_indices_as_jax():
    """Both of ENet's down blocks name some positions from two pooled
    cells on this input, and its logits equal JAX's (the last writer
    wins)."""
    jm, variables, tm = make_model_pair(jax_segnet_enet.ENet, {}, 64, 128)
    seen = []
    hooks = [getattr(tm, n).register_forward_hook(lambda m, i, o: seen.append(o[1]))
             for n in ("stage1_1", "stage2_1")]
    got = check_forward(jm, variables, tm, 64, 128, B=1)
    for h in hooks:
        h.remove()
    assert got.shape[0] == 1 and len(seen) >= 2
    assert all(duplicates(idx) > 0 for idx in seen[:2])


@pytest.mark.parametrize("name", ["segnet_32x64", "enet_64x128"])
def test_train_losses_and_grads_match_jax(name):
    """SegNet trains on BCE of logit channel 0 (its only loss, as in JAX);
    ENet on the weighted CE."""
    jax_cls, h, w = (jax_segnet_enet.SegNet, 32, 64) if name.startswith("segnet") else (
        jax_segnet_enet.ENet, 64, 128)
    jm, variables, tm = make_model_pair(jax_cls, {}, h, w)
    check_train(jm, variables, tm, h, w, B=2)


def test_bce_2d_matches_jax():
    """Logit channel 0 against clip(label, 0, 1), ignored pixels out; the
    other channels get no gradient."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 11, 4) * 3
    t = rng.randint(0, 19, (2, 9, 11)).astype(np.int32)
    t[0, :2] = 255
    t[1, 3] = 0
    want = jax_bce_2d(jnp.asarray(logits, jnp.float32), jnp.asarray(t))
    got = bce_2d(nchw(logits.astype(np.float32)), torch.from_numpy(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with jax.enable_x64(True):
        jg = jax.grad(lambda a: jax_bce_2d(a, jnp.asarray(t)))(jnp.asarray(logits))
    x = nchw(logits).requires_grad_()
    bce_2d(x, torch.from_numpy(t)).backward()
    np.testing.assert_allclose(nhwc(x.grad), np.asarray(jg), rtol=0, atol=1e-12)
    assert (x.grad[:, 1:] == 0).all()


@pytest.mark.parametrize("hw", [(5, 7), (4, 6)])
def test_transposed_cba_matches_flax_conv_transpose(hw):
    """flax ``ConvTranspose`` padding ((1, 2), (1, 2)) = torch
    ``ConvTranspose2d(3, 2, padding=1, output_padding=1)``, the kernel
    flipped by the weight carry, at an odd and an even size."""
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 8).astype(np.float32)
    jm = jax_segnet_enet._CBA(6, 3, act="prelu", transpose=True)
    variables = init_tree(jm, jnp.asarray(x), seed=1)
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_jax_variables(_CBA(8, 6, 3, act="prelu", transpose=True), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 6, 2 * hw[0], 2 * hw[1])
    assert rel_err(nhwc(got), want) < 1e-5


@pytest.mark.parametrize("hw", [(5, 7), (4, 6), (1, 1)])
def test_conv_transpose_2x_equals_torch_conv_transpose(hw):
    """The four-phase form of the stride-2 transposed convolution equals
    ``nn.ConvTranspose2d`` on the same weights within 1e-6, with and
    without a bias, and keeps its parameter layout (the weight carry's
    flip applies to it as to ``nn.ConvTranspose2d``)."""
    x = torch.from_numpy(np.random.RandomState(sum(hw)).randn(2, 6, *hw).astype(np.float32))
    for bias in (False, True):
        torch.manual_seed(len(hw) + bias)
        ours = ConvTranspose2x(6, 5, bias=bias)
        ref = torch.nn.ConvTranspose2d(6, 5, 3, 2, padding=1, output_padding=1, bias=bias)
        ref.load_state_dict(ours.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(ours(x).numpy(), ref(x).numpy(), rtol=0, atol=1e-6)
        assert isinstance(ours, torch.nn.ConvTranspose2d)


def test_enet_activations_and_names():
    """``c0`` is PReLU in every regular bottleneck, the ReLU stages too;
    a PReLU's one parameter is Flax's ``scale`` (``init_act/scale`` →
    ``init_act.weight``), initialised to 0.25."""
    tm = ENet(dictionary=({"a": 1.0}, {"b": 1.0}))
    assert hasattr(tm.stage4_2_0.c0, "act") and not hasattr(tm.stage4_2_0, "act")
    assert hasattr(tm.stage2_2_0, "act") and tm.stage2_2_0.c1a.act_kind == "prelu"
    assert tm.stage4_2_0.c1a.act_kind == "relu"
    assert tm.init_act.weight.shape == (1,) and tm.init_act.weight.item() == 0.25
    params = dict(tm.named_parameters())
    assert "init_act.weight" in params and "stage3_2.c1b.conv.weight" in params
    assert MODELS.get("ENet") is ENet and MODELS.get("SegNet") is SegNet
