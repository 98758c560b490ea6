"""ICNet, LEDNet, LSPNet and SGCPNet in the port (``models/light_seg2.py``,
``light_seg3.py``) and ``resize_align_corners`` against the JAX package on
the CPU, weights carried by ``load_jax_variables`` strictly.

Tolerances: ``resize_align_corners`` within 1e-6 of JAX's gather and lerp
(``F.interpolate`` rounds differently); the half-pixel nearest resize and
the channel shuffle exactly; the models as in ``tests/test_torch_stdc.py``
(eval logits 1e-4 of their largest |value| in float32, losses 1e-5
relative, float64 per-leaf gradients 5e-3).  ICNet runs on ResNet-18 (its
config's ``BACKBONE`` block), LEDNet with dropout off on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpytorch_tpu.models import light_seg2 as jax_light_seg2
from cvpytorch_tpu.models import light_seg3 as jax_light_seg3
from cvpytorch_tpu_torch.models.light_seg import resize_nearest
from cvpytorch_tpu_torch.models.light_seg2 import SSnbt, channel_shuffle
from cvpytorch_tpu_torch.models.light_seg3 import resize_align_corners
from cvpytorch_tpu_torch.registry import MODELS
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree, nchw, nhwc
from tests.test_torch_seg_models import rel_err
from tests.test_torch_stdc import check_forward, check_train, make_model_pair, no_dropout
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("src, dst", [((1, 1), (5, 7)), ((6, 9), (1, 1)), ((4, 6), (9, 13)),
                                      ((9, 13), (4, 6)), ((5, 8), (5, 3)), ((7, 7), (7, 7))])
def test_resize_align_corners_matches_jax(src, dst):
    x = np.random.RandomState(sum(src + dst)).randn(2, *src, 3).astype(np.float32)
    want = jax_light_seg3.resize_align_corners(jnp.asarray(x), dst)
    got = resize_align_corners(nchw(x), dst)
    assert got.shape == (2, 3, *dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src, dst", [((2, 3), (3, 5)), ((3, 5), (5, 9)), ((1, 2), (2, 3)),
                                      ((9, 17), (18, 34)), ((5, 7), (2, 3))])
def test_half_pixel_nearest_resize_equals_jax(src, dst):
    """SGCPNet's ``up_to`` and STDC's detail target: equal to
    ``jax.image.resize(..., "nearest")``, which at these ratios is not
    torch's "nearest"."""
    x = np.arange(np.prod(src), dtype=np.float32).reshape(1, 1, *src)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, *dst), "nearest"))
    np.testing.assert_array_equal(resize_nearest(torch.from_numpy(x), dst).numpy(), want)
    if src == (3, 5):
        assert not np.array_equal(F.interpolate(torch.from_numpy(x), dst).numpy(), want)


def test_channel_shuffle_is_jaxs_and_not_its_inverse():
    """NHWC (2, C/2) swapped: output channel 2k + g is input channel
    g·C/2 + k; the inverse order (C/2, 2) swapped is another permutation."""
    c = 8
    x = torch.arange(c, dtype=torch.float32).reshape(1, c, 1, 1)
    got = channel_shuffle(x).reshape(-1).tolist()
    want = np.asarray(jnp.arange(c).reshape(1, 1, 1, 2, c // 2).swapaxes(3, 4)).reshape(-1)
    assert got == want.tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    inverse = x.reshape(1, c // 2, 2, 1, 1).transpose(1, 2).reshape(-1).tolist()
    assert inverse != got


@pytest.mark.parametrize("dilation", [1, 5])
def test_ss_nbt_block_matches_jax(dilation):
    x = np.random.RandomState(dilation).randn(2, 9, 12, 16).astype(np.float32)
    jm = jax_light_seg2.SSnbt(dilation, 0.3)
    variables = init_tree(jm, jnp.asarray(x), seed=4)
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_jax_variables(SSnbt(16, dilation, 0.3), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert rel_err(nhwc(got), want) < 1e-5


ICNET = {"BACKBONE": {"name": "ResNet", "subtype": "resnet18", "out_stages": [2, 4]}}
CASES = {  # name: (JAX class, USE_MODEL, h, w)
    "icnet_r18_64x128": (jax_light_seg2.ICNet, ICNET, 64, 128),
    "lednet_64x128": (jax_light_seg2.LEDNet, {}, 64, 128),
    "lspnet_64x128": (jax_light_seg3.LSPNet, {"TYPE": "lspnet_s"}, 64, 128),
    "sgcpnet_64x128": (jax_light_seg3.SGCPNet, {}, 64, 128),
    # P6/P7 ratios that are not integers (2×3 → 3×5 …): half-pixel nearest
    "sgcpnet_72x136": (jax_light_seg3.SGCPNet, {}, 72, 136),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jax_cls, cfg, h, w = CASES[request.param]
    return make_model_pair(jax_cls, cfg, h, w), h, w


def test_forward_matches_jax(case):
    (jm, variables, tm), h, w = case
    with no_dropout(tm):
        check_forward(jm, variables, tm, h, w)


@pytest.mark.parametrize("name", ["icnet_r18_64x128", "lednet_64x128", "lspnet_64x128",
                                  "sgcpnet_72x136"])
def test_train_losses_and_grads_match_jax(name):
    """B = 2; ICNet's backbone runs twice a step (half and quarter
    input), so its BN statistics update twice.  ICNet's and LSPNet's
    losses are held in float64 only: at 64×128 their deepest maps are 1×1
    (ICNet's quarter-input layer4) and 1×2 (LSPNet's quarter-resolution
    path, 20 layers deep), so train-mode BN normalises 2 and 4 values a
    channel, and JAX's own float32 losses lie further than 1e-5 from its
    float64 ones."""
    jax_cls, cfg, h, w = CASES[name]
    jm, variables, tm = make_model_pair(jax_cls, cfg, h, w)
    check_train(jm, variables, tm, h, w, B=2,
                float32_losses=name.split("_")[0] not in ("icnet", "lspnet"))


def test_icnet_updates_the_backbone_statistics_twice_in_order():
    """One train forward: the running mean of the stem's BN equals two
    momentum-0.1 updates, on the half-size input first, then on the
    quarter-size one, as JAX's two calls leave it."""
    jm, variables, tm = make_model_pair(jax_light_seg2.ICNet, ICNET, 64, 128)
    x = np.random.RandomState(0).rand(2, 64, 128, 3).astype(np.float32)
    t = np.zeros((2, 64, 128), np.int32)
    _, new = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="train", mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        tm.train()(torch.from_numpy(x), torch.from_numpy(t), mode="train")
    want = np.asarray(new["batch_stats"]["backbone"]["stem_bn"]["mean"])
    np.testing.assert_allclose(tm.backbone.stem_bn.running_mean.numpy(), want, rtol=1e-5,
                               atol=1e-7)
    assert tm.backbone.stem_bn.num_batches_tracked == 2


def test_names_resolve():
    from cvpytorch_tpu_torch.models import light_seg2, light_seg3

    for name, mod in (("ICNet", light_seg2), ("LEDNet", light_seg2), ("LSPNet", light_seg3),
                      ("SGCPNet", light_seg3)):
        assert MODELS.get(name) is getattr(mod, name)
