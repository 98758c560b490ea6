"""SegFormer in the port (``MixVisionTransformer`` and ``SegFormerHead``)
against the JAX package on the CPU, weights carried by
``load_jax_variables``.

Tolerances: eval-mode logits and features within 1e-4 of their largest
value, float32; val losses within 1e-5 relative and the argmax equal;
per-leaf gradients within 5e-3 of the leaf's largest value in float64 on
both sides (as the other model tests hold them); one float32 train step
of the config's recipe (SGD, PolyLR, warmup, clip 10) with losses within
1e-5 relative and updated parameters within 1e-5 absolute + 1e-4
relative.  DropPath and dropout are 0 where both sides train: JAX draws
its masks from its own RNG, which no torch draw can match.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.models.backbones.seg_transformers import (
    MixVisionTransformer as JaxMiT)
from cvpytorch_tpu.models.heads.seg_heads import resize_bilinear as jax_resize
from cvpytorch_tpu.models.heads.seg_heads_extra import SegFormerHead as JaxSegFormerHead
from cvpytorch_tpu.models.segmentor import EncoderDecoder as JaxEncoderDecoder
from cvpytorch_tpu.optim.optimizers import build_optimizer as jax_build_optimizer
from cvpytorch_tpu.optim.schedules import build_lr_scheduler as jax_build_lr
from cvpytorch_tpu.train_state import TrainState as JaxTrainState
from cvpytorch_tpu.train_state import make_train_step as jax_make_train_step
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import bricks
from cvpytorch_tpu_torch.models.backbones.seg_transformers import (
    MixVisionTransformer, same_pad)
from cvpytorch_tpu_torch.models.heads.seg_heads_extra import SegFormerHead
from cvpytorch_tpu_torch.models.segmentor import EncoderDecoder
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
from cvpytorch_tpu_torch.registry import BACKBONES, HEADS, MODELS
from cvpytorch_tpu_torch.train_state import TrainState, make_train_step
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree, init_tree, nchw
from tests.test_torch_seg_models import batch, rel_err
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"class{i}": 1.0 + 0.05 * i} for i in range(19))
SEGFORMER = {"BACKBONE": {"name": "MixVisionTransformer", "subtype": "mit_b0",
                          "drop_path_rate": 0.0},
             "HEAD": {"name": "SegFormerHead", "channels": 32, "dropout": 0.0}}
RECIPE = {  # conf/cityscapes_segformer_b*.yml's optimizer, schedule and clip
    "INIT_LR": 6e-05, "N_MAX_EPOCHS": 200,
    "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.937, "WEIGHT_PARAMS": {"weight_decay": 0.0005}},
    "LR_SCHEDULER": {"TYPE": "PolyLR", "POWER": 0.9},
    "WARMUP": {"NAME": "linear", "ITERS": 1000, "FACTOR": 0.1},
    "GRAD_CLIP": {"TYPE": "norm", "VALUE": 10.0},
}
# 64×128: every stage's grid divides by its sr ratio (16×32 by 8, 8×16
# by 4, 4×8 by 2); 40×56: none does (10×14, 5×7, 3×4), so flax's SAME
# padding of the sr conv pads
SIZES = {"divides": (64, 128), "pads": (40, 56)}


def make_pair(h, w, seed=3, cfg=SEGFORMER):
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
        logits = jax_resize(m.head(feats, train=False), a.shape[1:3])
        return feats, logits, m(a, b, mode="val")

    return jax.jit(lambda v, a, b: jm.apply(v, a, b, method=run))(
        variables, jnp.asarray(x), jnp.asarray(t))


@pytest.mark.parametrize("case", sorted(SIZES))
def test_segformer_b0_forward_matches_jax(case):
    """Eval mode: the four MiT-b0 features and the logits at the input size
    within 1e-4 of their largest value; the val losses within 1e-5
    relative and the val and infer argmax equal."""
    h, w = SIZES[case]
    jm, variables, tm = make_pair(h, w)
    x, t = batch(h, w, seed=1)
    jfeats, want, (jl, jpred) = jax_eval(jm, variables, x, t)
    tm.eval()
    with torch.no_grad():
        images = torch.from_numpy(x)
        feats = tm.backbone(images.permute(0, 3, 1, 2))
        got = tm._logits(tm.head, feats, (h, w))
        tl, tpred = tm(images, torch.from_numpy(t), mode="val")
        tinfer = tm(images, mode="infer")
    assert [f.shape[1] for f in feats] == tm.backbone.channels == [32, 64, 160, 256]
    for f, jf in zip(feats, jfeats):
        assert rel_err(f.permute(0, 2, 3, 1).numpy(), jf) < 1e-4
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4
    np.testing.assert_allclose(float(tl["seg_loss"]), float(jl["seg_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(tinfer.numpy(), np.asarray(jpred))


def test_sr_conv_pads_as_flax_same():
    """flax "SAME" for kernel = stride = r: ⌊p/2⌋ before, the rest after."""
    x = torch.arange(2 * 3 * 10 * 13, dtype=torch.float32).reshape(2, 3, 10, 13)
    y = same_pad(x, 4)  # 10 → 12 (1 + 1), 13 → 16 (1 + 2)
    assert y.shape == (2, 3, 12, 16)
    assert torch.equal(y[:, :, 1:11, 1:14], x)
    assert same_pad(x[..., :8, :12], 4).shape == (2, 3, 8, 12)


def test_mit_classifier_matches_jax():
    """``classifier=True``: the logits of the Dense ``fc`` on the last
    stage's mean, within 1e-4 of their largest value."""
    x = np.random.RandomState(7).rand(2, 48, 64, 3).astype(np.float32)
    kw = dict(subtype="mit_b0", classifier=True, num_classes=11)
    jm = JaxMiT(**kw)
    variables = init_tree(jm, jnp.asarray(x), seed=8)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_jax_variables(MixVisionTransformer(**kw), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (2, 11)
    assert rel_err(got.numpy(), want) < 1e-4


def _jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, jnp.asarray(t), mode="train", mutable=["batch_stats"])
    return total, parts


def test_train_mode_loss_and_grads_match_jax():
    """Train mode (DropPath and dropout 0): the loss within 1e-5 relative
    in float32; per-leaf gradients within 5e-3 of the leaf's largest value
    in float64 on both sides."""
    h, w = SIZES["pads"]
    jm, variables, tm = make_pair(h, w, seed=4)
    x, t = batch(h, w, seed=2)
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
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    pairs = []
    for path, g in _flatten(jgrads):
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        name = ".".join(path[:-1] + (leaf,))
        pairs.append((name, _convert(name, g, tm.state_dict()[name],
                                     owners[".".join(path[:-1])]), grads[name]))
    assert len(pairs) == len(grads)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= 5e-3, worst


def test_one_train_step_matches_jax():
    """One float32 step of the config's recipe from step 500 (inside the
    warmup): losses within 1e-5 relative, every updated parameter and BN
    statistic within 1e-5 absolute + 1e-4 relative."""
    h, w = SIZES["divides"]
    jm, variables, tm = make_pair(h, w, seed=5)
    x, t = batch(h, w, seed=3)
    start = 500
    jcfg = JaxConfig(RECIPE)
    tx = jax_build_optimizer(jcfg, jax_build_lr(jcfg, 10))
    jstate = JaxTrainState(
        step=jnp.asarray(start, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        ema_params=None, ema_batch_stats=None, rng=jax.random.PRNGKey(0),
        apply_fn=jm.apply, tx=tx)
    jstate, jmetrics = jax_make_train_step(amp=False, donate=False)(
        jstate, {"image": jnp.asarray(x), "target": jnp.asarray(t)})

    cfg = CommonConfiguration(RECIPE)
    state = TrainState(model=tm, optimizer=build_optimizer(cfg, tm, build_lr_scheduler(cfg, 10)),
                       ema=None, step=start)
    state, metrics = make_train_step(amp=False)(
        state, {"image": torch.from_numpy(x), "target": torch.from_numpy(t)})
    assert state.step == int(jstate.step) == start + 1
    for k in ("loss", "seg_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    module = state.model
    params = module.state_dict()
    owners = dict(module.named_modules())
    moved = 0
    for coll, tree in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        for path, arr in _flatten(tree):
            leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
                    "mean": "running_mean", "var": "running_var"}[path[-1]]
            name = ".".join(path[:-1] + (leaf,))
            want = _convert(name, arr, params[name], owners[".".join(path[:-1])])
            np.testing.assert_allclose(params[name].numpy(), want, atol=1e-5, rtol=1e-4,
                                       err_msg=name)
            moved += coll == "params"
    assert moved == len(list(module.parameters()))


def test_drop_path_keeps_whole_samples():
    """In train mode a sample's branch is zeroed or scaled by 1/keep as a
    whole, about ``rate`` of the samples zeroed; eval mode is the
    identity."""
    dp = bricks.DropPath(0.25)
    x = torch.rand(4000, 3, 5) + 0.5
    torch.manual_seed(0)
    y = dp.train()(x)
    zeroed = (y == 0).all(-1).all(-1)
    assert abs(float(zeroed.float().mean()) - 0.25) < 0.03
    torch.testing.assert_close(y[~zeroed], x[~zeroed] / 0.75)
    assert ((y == 0).flatten(1).any(1) == zeroed).all()
    assert torch.equal(dp.eval()(x), x)


def test_drop_path_rates_follow_the_block_index():
    """Rate 0.1·b/(blocks − 1) over MiT-b2's 16 blocks, as in JAX."""
    m = MixVisionTransformer("mit_b2", drop_path_rate=0.1)
    rates = [getattr(m, f"dp1_{si}_{j}").rate for si, d in enumerate((3, 4, 6, 3))
             for j in range(d)]
    np.testing.assert_allclose(rates, [0.1 * b / 15 for b in range(16)])


def test_names_and_subtypes_resolve():
    for alias in ("MixVisionTransformer", "mit",
                  "src.models.backbones.mix_transformer.MixVisionTransformer"):
        assert BACKBONES.get(alias) is MixVisionTransformer
    assert HEADS.get("SegFormerHead") is SegFormerHead
    assert MODELS.get("SegFormer") is EncoderDecoder
    for sub, blocks in (("mit_b1", 8), ("mit_b3", 28), ("mit_b4", 41), ("mit_b5", 52)):
        m = MixVisionTransformer(sub)
        assert sum(m.depths) == blocks and m.channels == [64, 128, 320, 512]


def test_head_dense_carries_strictly():
    """The Flax Dense kernel (in, out) of ``linear{i}`` carries to the
    1×1 conv (out, in, 1, 1) transposed; a tree whose Dense has the wrong
    width raises."""
    feats = [np.random.RandomState(i).randn(2, 8 // (i + 1), 16 // (i + 1), c)
             .astype(np.float32) for i, c in enumerate((6, 10))]
    jm = JaxSegFormerHead(num_classes=5, channels=12)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=9)
    want = jm.apply(variables, tuple(jnp.asarray(f) for f in feats))
    tm = load_jax_variables(SegFormerHead([6, 10], num_classes=5, channels=12), variables)
    with torch.no_grad():
        got = tm.eval()([nchw(f) for f in feats])
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5
    with pytest.raises(KeyError, match="shape mismatch"):
        load_jax_variables(SegFormerHead([6, 11], num_classes=5, channels=12), variables)


def test_mit_tree_loads_strictly():
    """``load_jax_variables`` on the MiT tree: a block's ``sr_norm`` left
    out of the tree, or a key the port lacks, raises."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = init_tree(JaxMiT(subtype="mit_b0"), jnp.asarray(x), seed=1)
    load_jax_variables(MixVisionTransformer("mit_b0"), variables)
    missing = copy.deepcopy(jax.tree_util.tree_map(np.asarray, variables))
    del missing["params"]["attn0_1"]["sr_norm"]
    with pytest.raises(KeyError, match="attn0_1.sr_norm"):
        load_jax_variables(MixVisionTransformer("mit_b0"), missing)
    extra = copy.deepcopy(jax.tree_util.tree_map(np.asarray, variables))
    extra["params"]["attn3_0"]["sr"] = {"kernel": np.zeros((1, 1, 256, 256), np.float32)}
    with pytest.raises(KeyError, match="attn3_0/sr"):
        load_jax_variables(MixVisionTransformer("mit_b0"), extra)
