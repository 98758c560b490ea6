"""IncepFormer in the port (``IncepTransformer`` and ``UpConcatHead``)
against the JAX package on the CPU, weights carried by
``load_jax_variables``.

The attention's scale is 1.0 (the reference's quirk), so its logits grow
with the activations and the softmax amplifies rounding.  At these seeded
weights JAX's own float32 logits differ from its float64 ones by 3e-4–5e-4
of the largest logit in train mode; in eval mode, on the tree's random BN
statistics, the stage-4 attention logits reach ~2000 and the two differ by
2e-3.  The tolerances follow:

* the attention module, its pooled tokens (SAME and VALID counts) and
  UpConcatHead within 1e-5 of their largest value in float32;
* the whole model (IPT-T + UpConcatHead) in float64 on both sides within
  1e-4 of the largest logit: in eval mode on BN statistics settled on
  another batch, as training leaves them, at a size every ratio divides,
  and in train mode (BN on the batch's statistics) at one none does.  JAX's
  attention logits are float32 even there (the einsum's
  ``preferred_element_type``); the port rounds them as XLA does;
* the train-mode loss within 1e-5 relative in float32, and per-leaf
  gradients within 5e-3 of the leaf's largest value in float64.
DropPath and dropout are 0.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones.seg_transformers import _IncepAttention as JaxIncepAttention
from cvpytorch_tpu.models.heads.seg_heads import resize_bilinear as jax_resize
from cvpytorch_tpu.models.heads.seg_heads_extra import UpConcatHead as JaxUpConcatHead
from cvpytorch_tpu_torch.models.backbones.seg_transformers import (
    IncepAttention, IncepTransformer, same_pad)
from cvpytorch_tpu_torch.models.heads.seg_heads import resize_bilinear
from cvpytorch_tpu_torch.models.heads.seg_heads_extra import UpConcatHead
from cvpytorch_tpu_torch.models.segmentor import EncoderDecoder, feature_channels
from cvpytorch_tpu_torch.registry import BACKBONES, HEADS
from cvpytorch_tpu_torch.utils.porting import _flatten, load_jax_variables, port_name
from tests.test_torch_rcnn_ops import init_tree, nchw
from tests.test_torch_seg_models import batch, rel_err
from tests.test_torch_segnext import check_train_loss_and_grads, make_pair
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

INCEPFORMER = {"BACKBONE": {"name": "IncepTransformer", "subtype": "ipt_t",
                            "drop_path_rate": 0.0},
               "HEAD": {"name": "UpConcatHead", "channels": 64, "dropout": 0.0}}
# 64×128: every stage's grid divides by its ratio (16×32 by 8, 8×16 by 4,
# 4×8 by 2); 72×136: none does (18×34, 9×17, 5×9)
SIZES = {"divides": (64, 128), "pads": (72, 136)}


def settled(tm, x):
    """``tm`` in float64 with every BN's running statistics set to the
    batch statistics of ``x`` (a forward at momentum 1), as training
    leaves them."""
    tm = copy.deepcopy(tm).double().train()
    momenta = {m: m.momentum for m in tm.modules() if isinstance(m, torch.nn.BatchNorm2d)}
    for m in momenta:
        m.momentum = 1.0
    with torch.no_grad():
        tm.head(tm.backbone(torch.from_numpy(x).double().permute(0, 3, 1, 2)))
    for m, momentum in momenta.items():
        m.momentum = momentum
    return tm


def with_port_statistics(variables, tm):
    """The JAX tree with ``tm``'s BN running statistics."""
    state = tm.state_dict()
    stats = {}
    for path, _ in _flatten(variables["batch_stats"]):
        node = stats
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = state[port_name("batch_stats", path, {})].numpy()
    return {"params": variables["params"], "batch_stats": stats}


def _logits(m, a, train):
    return jax_resize(m.head(m.backbone(a, train=train), train=train), a.shape[1:3])


@pytest.mark.parametrize("case,train", [("divides", False), ("pads", True)],
                         ids=["eval_64x128", "train_72x136"])
def test_ipt_t_forward_matches_jax(case, train):
    """IPT-T + UpConcatHead in float64 on both sides, the logits within
    1e-4 of the largest: in eval mode (BN on running statistics settled on
    another batch) at the size the ratios divide, in train mode (BN on the
    batch's statistics) at the size they do not."""
    h, w = SIZES[case]
    jm, variables, tm = make_pair(INCEPFORMER, h, w)
    x, _ = batch(h, w, seed=1, B=1)
    x2, _ = batch(h, w, seed=2, B=1)
    tm = settled(tm, x2).train(train)
    with jax.enable_x64(True):
        as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      with_port_statistics(variables, tm))
        want = jax.jit(lambda v, a: jm.apply(v, a, train, method=_logits,
                                             mutable=["batch_stats"])[0])(
            as64, jnp.asarray(x, jnp.float64))
    with torch.no_grad():
        got = resize_bilinear(tm.head(tm.backbone(
            torch.from_numpy(x).double().permute(0, 3, 1, 2))), (h, w))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), np.asarray(want)) < 1e-4


@pytest.mark.parametrize("r", [8, 4, 2])
@pytest.mark.parametrize("hw", [(16, 32), (18, 34), (9, 17)])
def test_pooled_tokens_and_attention_match_jax(hw, r):
    """The pooled K/V tokens: ⌈H/r⌉·⌈W/r⌉ from each strided conv (flax
    "SAME"), ⌊H/r⌋·⌊W/r⌋ from the average pool ("VALID"), after the
    LayerNorm within 1e-5 of JAX's; the attention's output within 1e-5."""
    h, w = hw
    x = np.random.RandomState(h + r).randn(2, h, w, 64).astype(np.float32)
    jm = JaxIncepAttention(64, 2, r)
    variables = init_tree(jm, jnp.asarray(x), seed=r)
    want, state = jm.apply(variables, jnp.asarray(x), capture_intermediates=True)
    (pooled,) = state["intermediates"]["norm"]["__call__"]
    tm = load_jax_variables(IncepAttention(64, 2, r), variables)
    with torch.no_grad():
        got_pooled = tm.pooled(nchw(x))
        got = tm(nchw(x))
    up = -(-h // r) * -(-w // r)
    assert got_pooled.shape == (2, 2 * up + (h // r) * (w // r), 64) == pooled.shape
    assert rel_err(got_pooled.numpy(), pooled) < 1e-5
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5


def test_same_pad_per_axis():
    """(1, r) and (r, 1) strides pad one axis each: ⌊p/2⌋ before, the rest
    after."""
    x = torch.arange(2 * 3 * 10 * 13, dtype=torch.float32).reshape(2, 3, 10, 13)
    assert same_pad(x, (1, 4)).shape == (2, 3, 10, 16)
    assert torch.equal(same_pad(x, (1, 4))[..., 1:14], x)
    assert same_pad(x, (4, 1)).shape == (2, 3, 12, 13)
    assert torch.equal(same_pad(x, (4, 1))[:, :, 1:11], x)


def test_ipt_t_train_loss_and_grads_match_jax():
    """Train mode at 40×40, a size no ratio divides (10×10, 5×5, 3×3 at the
    reduction ratios 8, 4, 2): the loss and float64 per-leaf gradients.
    (XLA's float64 run takes most of the time, and it scales with the
    pixels; 40×40 is the smallest square size whose 1/4 map still holds
    a pooled token at ratio 8.)"""
    jm, variables, tm = make_pair(INCEPFORMER, 40, 40, seed=4)
    check_train_loss_and_grads(jm, variables, tm, 40, 40)


def test_up_concat_head_matches_jax():
    """Level 0 as it is, the others resized to it, concatenated in level
    order: within 1e-5 of the largest logit."""
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, 16 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((8, 12, 16, 20))]
    jm = JaxUpConcatHead(num_classes=5, channels=24)
    jf = tuple(jnp.asarray(f) for f in feats)
    variables = init_tree(jm, jf, seed=3)
    want = jm.apply(variables, jf)
    tm = load_jax_variables(UpConcatHead([8, 12, 16, 20], num_classes=5, channels=24),
                            variables).eval()
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5


def test_ipt_specs_rates_and_names():
    """The registry names; each subtype's depths; DropPath rates
    ``linspace(0, 0.1, blocks)``."""
    for alias in ("IncepTransformer", "ipt"):
        assert BACKBONES.get(alias) is IncepTransformer
    assert HEADS.get("UpConcatHead") is UpConcatHead
    for sub, blocks in (("ipt_t", 10), ("ipt_s", 21), ("ipt_b", 35)):
        m = IncepTransformer(sub)
        assert sum(m.depths) == blocks and m.channels == [64, 128, 320, 512]
    m = IncepTransformer("ipt_s")
    rates = [getattr(m, f"block{i + 1}_{j}").dp1.rate
             for i, d in enumerate(m.depths) for j in range(d)]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 21))
    seg = EncoderDecoder(dictionary=({"a": 1.0}, {"b": 1.0}), model_cfg=INCEPFORMER)
    assert feature_channels(seg.backbone) == [64, 128, 320, 512]
