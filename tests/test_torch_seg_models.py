"""The port's segmentation models against the JAX package on the CPU,
float32, with weights carried by ``load_jax_variables``: the depthwise
kernel's carry, the five heads (eval mode; PSP and UPer at a C5 that their
pool scales do not divide), the heads' dropout, ``EncoderDecoder``
(DeepLabV3+ on ResNet-18 at output stride 8, 64×128, 19 weighted
classes, FCN aux head: train-mode losses and per-leaf gradients, val
losses, infer argmax) and ``UNet`` (``base_channels`` 8 at 32×64)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.models import bricks as jax_bricks
from cvpytorch_tpu.models.heads import seg_heads as jax_heads
from cvpytorch_tpu.models.segmentor import EncoderDecoder as JaxEncoderDecoder
from cvpytorch_tpu.models.unet import UNet as JaxUNet
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import bricks
from cvpytorch_tpu_torch.models.heads import seg_heads
from cvpytorch_tpu_torch.models.segmentor import EncoderDecoder
from cvpytorch_tpu_torch.models.unet import UNet
from cvpytorch_tpu_torch.registry import MODELS
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree, init_tree, nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"class{i}": 1.0 + 0.05 * i} for i in range(19))
DEEPLAB = {
    "BACKBONE": {"name": "ResNet", "subtype": "resnet18", "output_stride": 8,
                 "out_stages": [1, 4]},
    "HEAD": {"name": "Deeplabv3PlusHead", "channels": 32, "dilations": [1, 12, 24, 36],
             "dropout": 0.0},
    "AUX_HEAD": {"name": "FCNHead", "channels": 32, "num_convs": 1, "is_concat": False,
                 "dropout": 0.0},
    "LOSS": {"name": "CrossEntropyLoss2d"},
}


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# -- bricks -------------------------------------------------------------------
def test_depthwise_kernel_carries_and_a_wrong_carry_would_fail():
    """Flax's depthwise kernel is (kh, kw, 1, C); the HWIO → OIHW transpose
    gives torch's (C, 1, kh, kw).  The output matches JAX within 1e-5 of
    its largest value; reading the kernel's memory as (C, 1, kh, kw)
    without the transpose also passes the shape check, and is far off."""
    x = np.random.RandomState(0).randn(2, 9, 11, 6).astype(np.float32)
    jm = jax_bricks.DepthwiseSeparableConv(8, 3, dilation=2)
    variables = init_tree(jm, jnp.asarray(x), seed=1)
    assert variables["params"]["dw"]["conv"]["kernel"].shape == (3, 3, 1, 6)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = load_jax_variables(bricks.DepthwiseSeparableConv(6, 8, 3, dilation=2), variables)
    assert tm.dw.conv.weight.shape == (6, 1, 3, 3) and tm.dw.conv.groups == 6
    with torch.no_grad():
        got = tm.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
        assert rel_err(got, want) < 1e-5
        k = np.asarray(variables["params"]["dw"]["conv"]["kernel"])
        tm.dw.conv.weight.copy_(torch.from_numpy(k.reshape(6, 1, 3, 3)))
        wrong = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert rel_err(wrong, want) > 0.1


def test_batch_norm_trains_on_one_value_per_channel_as_jax_does():
    """The global-pool branch at batch 1: torch's BatchNorm2d raises, the
    port's gives the bias and decays the running variance, as JAX."""
    x = np.random.RandomState(3).randn(1, 1, 1, 4).astype(np.float32)
    jm = jax_bricks.ConvBNAct(5, 1, act=None, bn_momentum=0.9, bn_eps=1e-5)
    variables = init_tree(jm, jnp.asarray(x), seed=2)
    want, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = load_jax_variables(bricks.ConvBNAct(4, 5, 1, act=None, bn_momentum=0.1,
                                             bn_eps=1e-5), variables)
    got = tm.train()(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), new["batch_stats"]["bn"]["mean"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), new["batch_stats"]["bn"]["var"],
                               rtol=1e-5)
    with pytest.raises(ValueError):
        torch.nn.BatchNorm2d(5).train()(torch.ones(1, 5, 1, 1))


# -- heads ----------------------------------------------------------------------
HEAD_CASES = {
    "FCNHead": dict(channels=16, num_convs=2, is_concat=True, dilation=2),
    "Deeplabv3Head": dict(channels=16, dilations=(1, 2, 3)),
    "Deeplabv3PlusHead": dict(channels=16, low_channels=8, dilations=(1, 2, 3)),
    "PSPHead": dict(channels=16, pool_scales=(1, 2, 3, 6)),
    "UPerHead": dict(channels=16, pool_scales=(1, 2, 3, 6)),
}


def head_features(seed=0):
    """C2..C5 of widths 8/12/16/20 at 20×28, 10×14, 5×7, 5×7: 5×7 is
    divided by no pool scale but 1, so scales 2, 3 and 6 take the
    antialiased resize (6 upsamples the 5 rows)."""
    rng = np.random.RandomState(seed)
    shapes = [(20, 28, 8), (10, 14, 12), (5, 7, 16), (5, 7, 20)]
    return [rng.randn(2, *s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", sorted(HEAD_CASES))
def test_head_matches_jax_in_eval_mode(name):
    """Logits within 1e-4 of their largest value."""
    feats = head_features()
    kwargs = HEAD_CASES[name]
    jm = getattr(jax_heads, name)(num_classes=7, **kwargs)
    jfeats = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jfeats, seed=4)
    want = np.asarray(jm.apply(variables, jfeats))
    tm = getattr(seg_heads, name)(in_channels=[f.shape[-1] for f in feats],
                                  num_classes=7, **kwargs)
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm.eval()([nchw(f) for f in feats]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-4


def test_pyramid_pool_is_jax_linear_resize_or_block_mean():
    x = np.random.RandomState(5).randn(2, 64, 128, 3).astype(np.float32)
    for s in (1, 2, 3, 6, 7):
        h, w = 64, 128
        if h % s or w % s:
            want = jax.image.resize(jnp.asarray(x), (2, s, s, 3), "linear")
        else:
            want = x.reshape(2, s, h // s, s, w // s, 3).mean((2, 4))
        got = seg_heads.pyramid_pool(nchw(x), s).permute(0, 2, 3, 1).numpy()
        assert rel_err(got, want) < 1e-5, s


def test_head_dropout_drops_in_train_mode_only():
    """p = 0.3 from the config: in train mode about 30 % of the nonzero
    activations in front of ``cls`` become zero and the rest are scaled by
    1/0.7; in eval mode the dropout is the identity."""
    feats = [nchw(f) for f in head_features(1)]
    head = seg_heads.FCNHead([8, 12, 16, 20], num_classes=3, channels=64, dropout=0.3)
    seen = []
    head.dropout.register_forward_hook(lambda m, i, o: seen.append((i[0], o)))
    torch.manual_seed(0)
    head.train()(feats)
    head.eval()(feats)
    (x_train, y_train), (x_eval, y_eval) = seen
    live = x_train != 0  # ReLU outputs
    dropped = (y_train == 0) & live
    assert abs(float(dropped.sum() / live.sum()) - 0.3) < 0.03
    kept = ~dropped
    torch.testing.assert_close(y_train[kept], x_train[kept] / 0.7)
    assert torch.equal(y_eval, x_eval)


# -- EncoderDecoder and UNet ----------------------------------------------------
def batch(h, w, seed=0, B=2):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, h, w, 3).astype(np.float32)
    labels = rng.randint(0, 19, (B, h, w)).astype(np.int32)
    labels[0, :4] = 255
    return images, labels


def make_pair(jax_cls, port_cls, model_cfg, h, w, seed, **kw):
    jm = jax_cls(dictionary=DICTIONARY, model_cfg=JaxConfig(model_cfg), **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w), jnp.int32),
        mode="train"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(
        port_cls(dictionary=DICTIONARY, model_cfg=CommonConfiguration(model_cfg), **kw),
        variables)
    return jm, variables, tm


MODELS_UNDER_TEST = {
    # name: (JAX class, port class, USE_MODEL, h, w, extra kwargs, loss keys)
    "deeplabv3plus_r18": (JaxEncoderDecoder, EncoderDecoder, DEEPLAB, 64, 128, {},
                          ("seg_loss", "aux_loss")),
    "unet_b8": (JaxUNet, UNet, {}, 32, 64, {"base_channels": 8}, ("ce_loss", "loss")),
}
SEED = 2  # weights: no ReLU/BN near-ties (see the gradient test)


@pytest.fixture(scope="module", params=sorted(MODELS_UNDER_TEST))
def pair(request):
    jax_cls, port_cls, cfg, h, w, kw, keys = MODELS_UNDER_TEST[request.param]
    return (*make_pair(jax_cls, port_cls, cfg, h, w, SEED, **kw), h, w, keys)


def train_losses(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), jnp.asarray(t), mode="train",
                                 mutable=["batch_stats"])
    return total, parts


def test_train_mode_losses_match_jax(pair):
    """Float32: the total and each loss within 1e-5 relative (the heads'
    dropout at 0)."""
    jm, variables, tm, h, w, keys = pair
    x, t = batch(h, w)
    jtotal, jparts = jax.jit(lambda p: train_losses(jm, variables, p, x, t))(
        variables["params"])
    with torch.no_grad():
        total, parts = copy.deepcopy(tm).train()(torch.from_numpy(x), torch.from_numpy(t),
                                                 mode="train")
    assert set(parts) == set(jparts) == set(keys)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in keys:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)


def test_train_mode_grads_match_jax(pair):
    """Per leaf, max |Δg| over max(leaf max |g|, 1e-3 · global max |g|) ≤
    5e-3, as ``tests/test_torch_rcnn.py`` holds Mask R-CNN, with both sides
    in float64.  In float32 no weight seed is free of near-ties at this
    size: for seeds 1–8 of DeepLabV3+ some leaf (in layer 4 or the head)
    lay 5–15 % off JAX, and the port's own float32 gradients lay as far
    from its float64 ones; a ReLU pre-activation within float32 rounding
    of 0 among ~10⁷ takes the other side, and layer 4 sums over only
    8×16 positions an image."""
    jm, variables, tm, h, w, keys = pair
    x, t = batch(h, w)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        jgrads = jax.jit(jax.grad(
            lambda p: train_losses(jm, as64, p, x.astype(np.float64), t)[0]))(as64["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tm = copy.deepcopy(tm).double().train()
    total, _ = tm(torch.from_numpy(x).double(), torch.from_numpy(t), mode="train")
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
    gmax = max(np.abs(t).max() for _, _, t in pairs)
    worst = max((float(np.abs(j - t).max() / max(np.abs(t).max(), 1e-3 * gmax)), n)
                for n, j, t in pairs)
    assert worst[0] <= 5e-3, worst


def test_val_losses_and_infer_argmax_match_jax(pair):
    """Val losses within 1e-5 relative (no aux loss in val); the val and
    infer argmax maps equal."""
    jm, variables, tm, h, w, keys = pair
    x, t = batch(h, w, seed=1)
    jl, jpred = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
        variables, jnp.asarray(x), jnp.asarray(t))
    jinfer = jax.jit(lambda v, a: jm.apply(v, a, mode="infer"))(variables, jnp.asarray(x))
    with torch.no_grad():
        tl, tpred = tm.eval()(torch.from_numpy(x), torch.from_numpy(t), mode="val")
        tinfer = tm(torch.from_numpy(x), mode="infer")
    assert set(tl) == set(jl) == (set(keys) - {"aux_loss"})
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    assert tpred.shape == tinfer.shape == (2, h, w)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(tinfer.numpy(), np.asarray(jinfer))
    assert len(np.unique(tinfer.numpy())) > 1


def test_class_weights_and_aux_weight_come_from_the_config():
    cfg = CommonConfiguration({**DEEPLAB, "AUX_WEIGHT": 0.25})
    m = EncoderDecoder(dictionary=DICTIONARY, model_cfg=cfg)
    assert m.aux_weight == 0.25 and m.num_classes == 19
    np.testing.assert_allclose(m.class_weights.numpy(), [1.0 + 0.05 * i for i in range(19)],
                               rtol=1e-6)
    assert "class_weights" not in m.state_dict()
    default = EncoderDecoder(dictionary=DICTIONARY, model_cfg=CommonConfiguration(
        {k: v for k, v in DEEPLAB.items() if k != "AUX_HEAD"}))
    assert default.aux_head is None and default.aux_weight == 0.4


def test_aliases_resolve_and_missing_parts_name_the_roadmap():
    for alias in ("Deeplabv3Plus", "Deeplabv3", "PSPNet", "UPerNet", "SegFormer",
                  "src.models.segmentors.encoder_decoder.EncoderDecoder"):
        assert MODELS.get(alias) is EncoderDecoder
    # every seg config's backbone and head is ported (the registry census,
    # tests/test_torch_registry_census.py, finds none left): ConvNeXt, the
    # last backbone, serves its stages 2-4; GFLv2's detection head builds
    # (with its own widths, as the JAX factory builds it); an unknown name
    # raises
    model = EncoderDecoder(dictionary=DICTIONARY, model_cfg=CommonConfiguration(
        {**DEEPLAB, "BACKBONE": {"name": "ConvNeXt", "out_stages": [1, 4]}}))
    assert type(model.backbone).__name__ == "ConvNeXt"
    assert model.backbone.channels == (96, 192, 384, 768)
    with pytest.raises(KeyError, match="NoSuchNet"):
        EncoderDecoder(dictionary=DICTIONARY,
                       model_cfg=CommonConfiguration({**DEEPLAB, "BACKBONE": {"name": "NoSuchNet"}}))
    model = EncoderDecoder(dictionary=DICTIONARY, model_cfg=CommonConfiguration(
        {**DEEPLAB, "HEAD": {"name": "GFocalHeadV2"}}))
    assert type(model.head).__name__ == "GFocalHeadV2"
    assert model.head.num_classes == len(DICTIONARY)


def test_unet_extra_loss_from_the_config():
    """``LOSS.EXTRA`` adds a named loss to the cross-entropy, as in JAX."""
    cfg = {"LOSS": {"EXTRA": "DiceLoss"}}
    jm, variables, tm = make_pair(JaxUNet, UNet, cfg, 32, 64, SEED, base_channels=8)
    x, t = batch(32, 64, seed=3)
    jl, _ = jax.jit(lambda v, a, b: jm.apply(v, a, b, mode="val"))(
        variables, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        tl, _ = tm.eval()(torch.from_numpy(x), torch.from_numpy(t), mode="val")
    assert set(tl) == set(jl) == {"ce_loss", "extra_loss", "loss"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
