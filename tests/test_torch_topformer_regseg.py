"""TopFormer and RegSeg in the port (``backbones/seg_light.py``: the
backbones and their heads) against the JAX package on the CPU, weights
carried by ``load_jax_variables``.

Tolerances: eval-mode features and logits within 1e-4 of their largest
value in float32, val losses within 1e-5 relative and the argmax equal;
the train-mode loss within 1e-5 relative in float32 and per-leaf
gradients within 5e-3 of the leaf's largest value in float64 on both
sides; single blocks and the classifiers within 1e-5 and 1e-4.  Dropout
is 0 where both sides train (the backbones have no DropPath).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones.seg_light import RegSegBackbone as JaxRegSeg
from cvpytorch_tpu.models.backbones.seg_light import TopFormerBackbone as JaxTopFormer
from cvpytorch_tpu.models.backbones.seg_light import _DBlock as JaxDBlock
from cvpytorch_tpu_torch.models.backbones.seg_light import (
    DBlock, RegSegBackbone, RegSegHead, TopFormerBackbone, TopFormerHead)
from cvpytorch_tpu_torch.models.segmentor import EncoderDecoder, feature_channels
from cvpytorch_tpu_torch.registry import BACKBONES, HEADS, MODELS
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree, nchw
from tests.test_torch_seg_models import rel_err
from tests.test_torch_segnext import check_eval_forward, check_train_loss_and_grads, make_pair
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

TOPFORMER = {"BACKBONE": {"name": "TopFormerBackbone", "subtype": "topformer_t"},
             "HEAD": {"name": "TopFormerHead", "channels": 32, "dropout": 0.0}}
REGSEG = {"BACKBONE": {"name": "RegSegBackbone", "out_stages": [2, 3, 4]},
          "HEAD": {"name": "RegSegHead", "channels": 64, "dropout": 0.0}}
# 64×128 divides everywhere; at 72×136 RegSeg's stride-2 shortcuts pad odd
# sizes (9×17 → 5×9 at /16), where TopFormer's pooling does not divide
CASES = {"topformer_64x128": (TOPFORMER, 64, 128), "regseg_64x128": (REGSEG, 64, 128),
         "regseg_72x136": (REGSEG, 72, 136)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    cfg, h, w = CASES[case]
    jm, variables, tm = make_pair(cfg, h, w)
    check_eval_forward(jm, variables, tm, h, w)


@pytest.mark.parametrize("case", ["topformer_64x128", "regseg_72x136"])
def test_train_loss_and_grads_match_jax(case):
    """TopFormer on 2 images: at 64×128 its transformer runs on 1×2 maps,
    and a train-mode BN over one image's 2 values is so ill-conditioned
    that JAX's own float32 loss is 3e-3 off its float64 one."""
    cfg, h, w = CASES[case]
    jm, variables, tm = make_pair(cfg, h, w, seed=4)
    check_train_loss_and_grads(jm, variables, tm, h, w, B=2 if cfg is TOPFORMER else 1)


def test_topformer_pool_refuses_sizes_that_do_not_divide():
    """At 72×136 the token levels (18×34 … 3×5) pool to 2×3, which 34 does
    not divide: JAX asserts, the port raises ``ValueError`` naming the
    sizes, where ``F.adaptive_avg_pool2d`` would average overlapping
    windows."""
    x = np.zeros((1, 72, 136, 3), np.float32)
    with pytest.raises(AssertionError):
        init_tree(JaxTopFormer(), jnp.asarray(x))
    with pytest.raises(ValueError, match="18x34 map to 2x3"):
        TopFormerBackbone()(nchw(x))


def test_topformer_out_stages_are_zero_based_positions():
    """``out_stages`` (0, 2): the SIM outputs of token levels 0 and 2, each
    of ``out_ch`` channels, within 1e-4 of JAX's."""
    x = np.random.RandomState(3).rand(2, 64, 128, 3).astype(np.float32)
    jm = JaxTopFormer(subtype="topformer_t", out_stages=(0, 2))
    variables = init_tree(jm, jnp.asarray(x), seed=2)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(TopFormerBackbone("topformer_t", out_stages=(0, 2)),
                            variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert [tuple(f.shape) for f in got] == [(2, 128, 16, 32), (2, 128, 4, 8)]
    for f, jf in zip(got, want):
        assert rel_err(f.permute(0, 2, 3, 1).numpy(), jf) < 1e-4


@pytest.mark.parametrize("hw", [(9, 13), (8, 12)])
def test_regseg_strided_block_matches_jax(hw):
    """A stride-2 D-block with two dilations: an odd map's shortcut is
    zero-padded and averaged 2×2 (the padded edge divided by 4), within
    1e-5 of JAX's."""
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 32).astype(np.float32)
    jm = JaxDBlock(64, stride=2, dilations=(1, 2))
    variables = init_tree(jm, jnp.asarray(x), seed=1)
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_jax_variables(DBlock(32, 64, stride=2, dilations=(1, 2)), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5


@pytest.mark.parametrize("name", ["topformer", "regseg"])
def test_classifier_matches_jax(name):
    """``classifier=True``: the Dense ``fc`` on the mean of the last
    output, within 1e-4 of the largest logit."""
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    jcls, cls = {"topformer": (JaxTopFormer, TopFormerBackbone),
                 "regseg": (JaxRegSeg, RegSegBackbone)}[name]
    jm = jcls(classifier=True, num_classes=9)
    variables = init_tree(jm, jnp.asarray(x), seed=6)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(cls(classifier=True, num_classes=9), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 9)
    assert rel_err(got.numpy(), want) < 1e-4


def test_feature_channels_follow_what_the_backbone_returns():
    """TopFormer: ``out_ch`` for each chosen 0-based position; RegSeg: the
    legacy (2, 3, 4) and (1, 2, 3) both give the /4, /8 and /16 widths."""
    for sub, out_ch in (("topformer_t", 128), ("topformer_s", 192), ("topformer_b", 256)):
        assert feature_channels(TopFormerBackbone(sub)) == [out_ch] * 3
    assert feature_channels(TopFormerBackbone("topformer_b", out_stages=(0, 3))) == [256, 256]
    for stages in ((2, 3, 4), (1, 2, 3)):
        assert feature_channels(RegSegBackbone(stages)) == [48, 128, 320]
    assert feature_channels(RegSegBackbone((1, 3))) == [48, 320]
    seg = EncoderDecoder(dictionary=({"a": 1.0}, {"b": 1.0}), model_cfg=REGSEG)
    assert seg.head.head4.conv.in_channels == 48 and seg.head.head16.conv.in_channels == 320


def test_names_resolve():
    for alias in ("TopFormerBackbone", "TopFormer_bb"):
        assert BACKBONES.get(alias) is TopFormerBackbone
    for alias in ("RegSegBackbone", "RegSeg_bb"):
        assert BACKBONES.get(alias) is RegSegBackbone
    assert HEADS.get("TopFormerHead") is TopFormerHead
    assert HEADS.get("RegSegHead") is RegSegHead
    assert MODELS.get("TopFormer") is MODELS.get("RegSeg") is EncoderDecoder
