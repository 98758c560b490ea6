"""SFNet in the port (``UperNetAlignHead`` with its flow warp) against the
JAX package on the CPU, weights carried by ``load_jax_variables``.

Tolerances: the bilinear sampler and the flow warp within 1e-5 of their
largest value and their gradients (to the map and to the grid) within
1e-4, float32; the model's eval-mode logits within 1e-4 of their largest
value, val losses within 1e-5 relative and the argmax equal; the train
loss within 1e-5 relative and per-leaf gradients within 5e-3 of the
leaf's largest value in float64 on both sides (ResNet's ReLU and BN
near-ties, ROADMAP's gradient-precision trap), dropout 0.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.models.heads import seg_heads_extra as jax_extra
from cvpytorch_tpu.models.heads.seg_heads import resize_bilinear as jax_resize
from cvpytorch_tpu.models.segmentor import EncoderDecoder as JaxEncoderDecoder
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models.heads import seg_heads, seg_heads_extra
from cvpytorch_tpu_torch.models.segmentor import EncoderDecoder
from cvpytorch_tpu_torch.registry import HEADS, MODELS
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree, nchw
from tests.test_torch_seg_models import batch, rel_err
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

DICTIONARY = tuple({f"class{i}": 1.0 + 0.05 * i} for i in range(19))
SFNET = {  # conf/cityscapes_sfnet_r18.yml's model, the head narrowed to 16
    "BACKBONE": {"name": "ResNet", "subtype": "resnet18v1c", "out_stages": [1, 2, 3, 4],
                 "output_stride": 8},
    "HEAD": {"name": "UperNetAlignHead", "channels": 16, "bins": [1, 2, 3, 6],
             "dropout": 0.0},
}
# C5 at 8×12: bins 1 and 2 divide it, 3 and 6 do not; the SFNet PPM takes
# the antialiased linear resize for all four (a block mean, as UPerHead's
# pool takes for a bin that divides, puts the logits 1.3e-2 off JAX)
H, W = 64, 96


def sample_inputs(seed=0):
    """A (2, 7, 9, 4) map and a grid reaching up to 0.6 past every edge."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 7, 9, 4).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (2, 5, 6, 2)).astype(np.float32)
    return x, grid


def test_grid_sample_matches_jax_and_extrapolates():
    """Values and both gradients equal JAX's; off the map the sampler
    extrapolates, so it is not ``F.grid_sample(padding_mode="border")``."""
    x, grid = sample_inputs()
    cot = np.random.RandomState(1).randn(2, 5, 6, 4).astype(np.float32)

    def jf(a, g):
        return jnp.sum(jax_extra.grid_sample_bilinear(a, g) * cot)

    want = jax_extra.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid))
    jgx, jgg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(grid))
    tx = nchw(x).requires_grad_()
    tg = torch.from_numpy(grid).requires_grad_()
    got = seg_heads_extra.grid_sample_bilinear(tx, tg)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert rel_err(got, want) < 1e-5
    assert rel_err(tx.grad.permute(0, 2, 3, 1).numpy(), jgx) < 1e-4
    assert rel_err(tg.grad.numpy(), jgg) < 1e-4
    border = F.grid_sample(nchw(x), torch.from_numpy(grid), mode="bilinear",
                           padding_mode="border", align_corners=True)
    outside = (np.abs(grid) > 1).any(-1)
    inside = ~outside
    np.testing.assert_allclose(border.permute(0, 2, 3, 1).numpy()[inside], got[inside],
                               atol=1e-5)
    assert np.abs(border.permute(0, 2, 3, 1).numpy()[outside] - got[outside]).max() > 0.1


def test_flow_warp_matches_jax():
    """A (2, 6, 8, 5) map warped to 11×13 by a flow of up to ±4 pixels
    (past the edges): within 1e-5 of the largest value."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 11, 13, 2)).astype(np.float32)
    want = jax_extra._flow_warp(jnp.asarray(x), jnp.asarray(flow), (11, 13))
    got = seg_heads_extra._flow_warp(nchw(x), torch.from_numpy(flow), (11, 13))
    assert got.shape == (2, 5, 11, 13)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5


@pytest.mark.parametrize("size", [(1, 1), (2, 2), (3, 3), (6, 6), (5, 200), (64, 128)])
def test_resize_linear_is_jax_linear_resize(size):
    """The PPM's resize (and PSP/UPer's for bins that do not divide) against
    ``jax.image.resize(..., "linear")`` on a 64×128 map, down to 1×1 (a
    128× downscale, which the CUDA antialiased ``F.interpolate`` refuses),
    across and up: within 1e-5 of the largest value."""
    x = np.random.RandomState(4).randn(2, 64, 128, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *size, 3), "linear")
    got = seg_heads.resize_linear(nchw(x), size).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("name", ["PSPHead", "UPerHead", "UperNetAlignHead"])
def test_pyramid_heads_run_under_bf16_autocast(name):
    """Under AMP the heads' antialiased resize gets bfloat16 maps, which
    the antialiased ``F.interpolate`` takes on neither device (no bf16
    kernel on the CPU; on the card it refuses large downscales): logits
    of bf16 features under autocast within 5e-2 of the float32 ones."""
    rng = np.random.RandomState(6)
    shapes = [(20, 28, 8), (10, 14, 12), (5, 7, 16), (5, 7, 20)]
    feats = [nchw(rng.randn(2, *sh).astype(np.float32)) for sh in shapes]
    head = HEADS.get(name)([sh[-1] for sh in shapes], num_classes=5, channels=16,
                           dropout=0.0).eval()
    with torch.no_grad():
        want = head(feats)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = head([f.bfloat16() for f in feats])
    assert got.dtype == torch.bfloat16 and rel_err(got.float().numpy(), want.numpy()) < 5e-2


def make_pair(seed=2):
    jm = JaxEncoderDecoder(dictionary=DICTIONARY, model_cfg=JaxConfig(SFNET))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W), jnp.int32),
        mode="train"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(
        EncoderDecoder(dictionary=DICTIONARY, model_cfg=CommonConfiguration(SFNET)), variables)
    return jm, variables, tm


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_sfnet_r18_forward_matches_jax(pair):
    """Eval mode at 64×96: logits within 1e-4 of their largest value, val
    loss within 1e-5 relative, the val and infer argmax equal."""
    jm, variables, tm = pair
    x, t = batch(H, W, seed=1)

    def run(m, a, b):
        logits = jax_resize(m.head(m.backbone(a, train=False), train=False), a.shape[1:3])
        return logits, m(a, b, mode="val")

    want, (jl, jpred) = jax.jit(lambda v, a, b: jm.apply(v, a, b, method=run))(
        variables, jnp.asarray(x), jnp.asarray(t))
    tm = copy.deepcopy(tm).eval()
    with torch.no_grad():
        images = torch.from_numpy(x)
        got = tm._logits(tm.head, tm.backbone(images.permute(0, 3, 1, 2)), (H, W))
        tl, tpred = tm(images, torch.from_numpy(t), mode="val")
        tinfer = tm(images, mode="infer")
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4
    np.testing.assert_allclose(float(tl["seg_loss"]), float(jl["seg_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(tinfer.numpy(), np.asarray(jpred))
    assert len(np.unique(tinfer.numpy())) > 1


def _jax_train(jm, variables, params, x, t):
    (total, parts), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, jnp.asarray(t), mode="train", mutable=["batch_stats"])
    return total, parts


def test_sfnet_r18_loss_and_grads_match_jax(pair):
    """Train mode: the loss within 1e-5 relative in float32; per-leaf
    gradients within 5e-3, float64 on both sides."""
    jm, variables, tm = pair
    x, t = batch(H, W, seed=2)
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
    assert any(n.startswith("head.align0.flow_make") for n, _, _ in pairs)
    gmax = max(np.abs(g).max() for _, _, g in pairs)
    worst = max((float(np.abs(j - g).max() / max(np.abs(g).max(), 1e-3 * gmax)), n)
                for n, j, g in pairs)
    assert worst[0] <= 5e-3, worst


def test_names_resolve():
    for alias in ("UperNetAlignHead", "SFNetHead"):
        assert HEADS.get(alias) is seg_heads_extra.UperNetAlignHead
    assert MODELS.get("SFNet") is EncoderDecoder
