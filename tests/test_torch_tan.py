"""The port's NanoDet v1 necks, PAN and TAN, against the JAX package on the
CPU, with one set of weights carried across by ``load_jax_variables``, and
the weight carry's rule for Flax's attention ``DenseGeneral`` kernels.

Tolerances: every output level within 1e-4 of its largest value in
float32 (eval mode, and TAN's train mode with its dropout rate at 0,
whose BN statistics then agree too); the running statistics within 1e-4.
TAN's train-mode dropout is checked on its own: the share of attention
weights dropped, one mask shared by every image and head, the kept ones
scaled by 1/(1 − rate).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvpytorch_tpu.models.necks import pan as jax_pan
from cvpytorch_tpu.models.necks import tan as jax_tan
from cvpytorch_tpu_torch.models.bricks import MultiHeadDense
from cvpytorch_tpu_torch.models.necks.pan import PAN
from cvpytorch_tpu_torch.models.necks.tan import TAN, MultiHeadAttention
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

B = 2


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def assert_close_to_scale(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


def pyramid(sizes, channels, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, w, c).astype(np.float32) for (h, w), c in zip(sizes, channels)]


@pytest.mark.parametrize("sizes", [[(16, 16), (8, 8), (4, 4)], [(9, 9), (5, 5), (3, 3)],
                                   [(10, 14), (5, 7), (3, 4)]],
                         ids=["halving", "odd", "uneven"])
def test_pan_matches_jax(sizes):
    """Levels that halve evenly, and ones that do not (9 → 5 → 3, 7 → 4):
    the bilinear up- and downsampling without antialias."""
    channels = (16, 24, 32)
    feats = pyramid(sizes, channels)
    jm = jax_pan.PAN(out_channels=12)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=4)
    tm = load_jax_variables(PAN(channels, 12), variables).eval()
    want = jm.apply(variables, tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)


def tan_pair(sizes, feature_hw, dropout=0.0, num_encoders=1, seed=4):
    channels = (16, 24, 32)
    feats = pyramid(sizes, channels)
    kw = dict(out_channels=32, feature_hw=feature_hw, num_heads=4, num_encoders=num_encoders,
              mlp_ratio=2, dropout_ratio=dropout)
    jm = jax_tan.TAN(**kw)
    variables = init_tree(jm, tuple(jnp.asarray(f) for f in feats), seed=seed)
    tm = load_jax_variables(TAN(channels, **kw), variables)
    return jm, variables, tm, feats


@pytest.mark.parametrize("sizes,feature_hw,num_encoders", [
    ([(16, 16), (8, 8), (4, 4)], (8, 8), 1),
    ([(16, 16), (8, 8), (4, 4)], (6, 6), 2),
    ([(10, 14), (5, 7), (3, 4)], (5, 7), 1),
], ids=["feature_hw", "resized_pos_embed", "uneven"])
def test_tan_matches_jax(sizes, feature_hw, num_encoders):
    """Eval mode: Flax's multi-head attention, LayerNorm eps 1e-6, the
    leaky-ReLU MLP; the positional embedding resized where the middle map
    is not ``feature_hw``."""
    jm, variables, tm, feats = tan_pair(sizes, feature_hw, num_encoders=num_encoders)
    want = jm.apply(variables, tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        got = tm.eval()([nchw(f) for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)


def test_tan_train_mode_matches_jax_without_dropout():
    """Train mode with the dropout rate at 0: the outputs and the BN
    running statistics."""
    jm, variables, tm, feats = tan_pair([(16, 16), (8, 8), (4, 4)], (8, 8))
    want, new_vars = jm.apply(variables, tuple(jnp.asarray(f) for f in feats), train=True,
                              mutable=["batch_stats"])
    trained = copy.deepcopy(tm).train()
    with torch.no_grad():
        got = trained([nchw(f) for f in feats])
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)
    want_stats = load_jax_variables(copy.deepcopy(tm), {**variables, **new_vars}).state_dict()
    for k, v in trained.state_dict().items():
        if "running" in k:
            assert_close_to_scale(v.numpy(), want_stats[k].numpy())


def test_tan_dropout_in_train_mode():
    """Rate 0.1 on the attention weights: with the projections set so that
    every weight is 1/n, the output shows the mask; about 10 % of the
    (tokens, tokens) weights dropped, the same for every image and head,
    kept ones ×1/0.9; eval mode drops none."""
    torch.manual_seed(0)
    n, c, heads = 64, 8, 2
    attn = MultiHeadAttention(c, heads, dropout_rate=0.1)
    with torch.no_grad():
        for m in (attn.query, attn.key):
            m.weight.zero_()
            m.bias.zero_()
        attn.value.weight.zero_()
        attn.value.bias.fill_(1.0)  # every value 1: the output is the row sum of the weights
        attn.out.weight.copy_(torch.eye(c))
        attn.out.bias.zero_()
    x = torch.randn(3, n, c)
    with torch.no_grad():
        y = attn.train()(x)  # (3, n, c): Σ_k w_qk·mask_qk/0.9 for each head's channels
    sums = y * 0.9 * n  # kept weights per query row
    assert torch.allclose(sums, sums[:1].expand_as(sums))  # one mask for all images
    assert torch.allclose(sums[..., :c // heads], sums[..., c // heads:])  # and all heads
    dropped = 1 - sums[0, :, 0] / n
    assert 0.07 < float(dropped.mean()) < 0.13
    np.testing.assert_allclose(attn.eval()(x).detach().numpy(), np.ones((3, n, c)), rtol=1e-6)


class _JaxAttention(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=16, name="attn")(x, x)


class _PortAttention(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiHeadAttention(16, 4)


def test_dense_general_rule_is_strict():
    """``query``/``key``/``value`` kernels (C, H, D) and ``out`` (H, D, C)
    carry by the ``MultiHeadDense`` rule; a tree whose kernel has another
    head split, or a plain Dense kernel, raises ``KeyError``."""
    x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
    variables = init_tree(_JaxAttention(), jnp.asarray(x), seed=1)
    port = load_jax_variables(_PortAttention(), variables)
    with torch.no_grad():
        got = port.attn(torch.from_numpy(x))
    assert_close_to_scale(got.numpy(), _JaxAttention().apply(variables, jnp.asarray(x)))
    params = variables["params"]["attn"]
    bad = [("query", "kernel", params["query"]["kernel"].reshape(16, 2, 8)),
           ("out", "kernel", params["out"]["kernel"].reshape(2, 8, 16)),
           ("key", "kernel", params["key"]["kernel"].reshape(16, 16)),
           ("value", "bias", params["value"]["bias"].reshape(16))]
    for layer, leaf, arr in bad:
        tree = jax.tree_util.tree_map(lambda a: a, variables)
        tree["params"]["attn"][layer][leaf] = arr
        with pytest.raises(KeyError, match="shape mismatch"):
            load_jax_variables(_PortAttention(), tree)
    assert isinstance(port.attn.out, MultiHeadDense) and port.attn.out.split == "merge"
