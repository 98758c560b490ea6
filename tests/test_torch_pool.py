"""``ops/pool.py`` in the port against ``cvpytorch_tpu/ops/pool.py`` on the
CPU: max pooling with indices and max unpooling, the pairs SegNet
(2×2/s2/p0) and ENet (3×3/s2/p1) are built on.

Tolerances: none.  Values and indices are equal; gradients are equal in
float64 (a tied maximum's gradient split equally among the tied taps, an
unpooled position's gradient to the last pooled cell that names it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpytorch_tpu.ops.pool import max_pool_argmax as jax_pool
from cvpytorch_tpu.ops.pool import max_unpool as jax_unpool
from cvpytorch_tpu_torch.ops.pool import max_pool_argmax, max_unpool

# (kernel, stride, padding, H, W): SegNet's and ENet's pools, odd sizes,
# padded edges
CASES = {"segnet_2x2_8x12": (2, 2, 0, 8, 12), "segnet_2x2_odd_9x13": (2, 2, 0, 9, 13),
         "enet_3x3_8x8": (3, 2, 1, 8, 8), "enet_3x3_odd_7x11": (3, 2, 1, 7, 11),
         "lednet_like_3x3_s1_p1": (3, 1, 1, 6, 5)}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def inputs(h, w, seed, c=4):
    """Half the channels random floats, half small integers (tied
    maxima in most windows, negative values at the padded edges)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, c)
    x[..., c // 2:] = rng.randint(-2, 2, (2, h, w, c - c // 2))
    return x


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_values_indices_and_grads_equal_jax(case):
    k, s, p, h, w = CASES[case]
    x = inputs(h, w, seed=sum(CASES[case]))
    want, want_idx = jax_pool(jnp.asarray(x, jnp.float32), k, s, p)
    got, idx = max_pool_argmax(nchw(x.astype(np.float32)), k, s, p)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(nhwc(idx), np.asarray(want_idx))

    weights = np.random.RandomState(1).randn(*want.shape)
    with jax.enable_x64(True):
        jgrad = jax.grad(lambda a: (jax_pool(a, k, s, p)[0] * weights).sum())(
            jnp.asarray(x, jnp.float64))
    tx = nchw(x).requires_grad_()
    (max_pool_argmax(tx, k, s, p)[0] * nchw(weights)).sum().backward()
    np.testing.assert_array_equal(nhwc(tx.grad), np.asarray(jgrad))


def test_tied_window_gradient_is_split_as_jax_splits_it():
    """A window [[1, 1], [0, 0]]: the index is the first maximum (0), the
    gradient .5 to each tied tap, where ``F.max_pool2d`` gives it all to
    one."""
    x = torch.tensor([[[[1.0, 1.0], [0.0, 0.0]]]], requires_grad=True)
    pooled, idx = max_pool_argmax(x, 2, 2, 0)
    pooled.sum().backward()
    assert int(idx) == 0
    np.testing.assert_array_equal(x.grad.numpy().ravel(), [0.5, 0.5, 0.0, 0.0])
    y = x.detach().clone().requires_grad_()
    F.max_pool2d(y, 2, 2).sum().backward()
    np.testing.assert_array_equal(y.grad.numpy().ravel(), [1.0, 0.0, 0.0, 0.0])


def duplicate_case():
    """ENet's 3×3/s2/p1 on an 8×8×4 random map: overlapping windows name
    some input positions from two pooled cells."""
    x = np.random.RandomState(0).randn(2, 8, 8, 4).astype(np.float32)
    pooled, idx = jax_pool(jnp.asarray(x), 3, 2, 1)
    idx = np.asarray(idx)
    values = np.random.RandomState(2).randn(*pooled.shape).astype(np.float32)
    return values, idx


def test_duplicate_indices_exist_in_enets_pools():
    _, idx = duplicate_case()
    flat = idx.transpose(0, 3, 1, 2).reshape(8, -1)
    duplicates = sum(len(row) - len(np.unique(row)) for row in flat)
    assert duplicates >= 15


@pytest.mark.parametrize("case", ["duplicates_enet_8x8", "segnet_2x2_odd_9x13"])
def test_unpool_and_its_grads_equal_jax(case):
    """The last writer in row-major pooled order wins, and only it gets a
    gradient: values equal, float64 gradients equal."""
    if case == "duplicates_enet_8x8":
        values, idx = duplicate_case()
        out_hw = (8, 8)
    else:
        x = inputs(9, 13, seed=3)
        _, idx = jax_pool(jnp.asarray(x, jnp.float32), 2, 2, 0)
        idx = np.asarray(idx)
        values = np.random.RandomState(4).randn(*idx.shape).astype(np.float32)
        out_hw = (9, 13)
    want = jax_unpool(jnp.asarray(values), jnp.asarray(idx), out_hw)
    got = max_unpool(nchw(values), nchw(idx).long(), out_hw)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))

    weights = np.random.RandomState(5).randn(*want.shape)
    with jax.enable_x64(True):
        jgrad = jax.grad(lambda v: (jax_unpool(v, jnp.asarray(idx), out_hw) * weights).sum())(
            jnp.asarray(values, jnp.float64))
    tv = nchw(values.astype(np.float64)).requires_grad_()
    (max_unpool(tv, nchw(idx).long(), out_hw) * nchw(weights)).sum().backward()
    np.testing.assert_array_equal(nhwc(tv.grad), np.asarray(jgrad))
    if case == "duplicates_enet_8x8":  # the losers of a duplicate get no gradient
        assert (np.asarray(jgrad) == 0).sum() > 0


def test_torch_max_unpool2d_differs_on_duplicates():
    """The regression: on the same duplicate indices ``F.max_unpool2d``
    gives a gradient to every pooled cell, the losers of a duplicate too
    (its backward gathers at each index), where JAX gives the losers none;
    on the card its forward also leaves the writer to the scheduler.  So
    the port does not call it.  (On this CPU its forward writes the cells
    in order, and equals JAX's.)"""
    values, idx = duplicate_case()
    weights = np.random.RandomState(5).randn(2, 8, 8, 4)
    with jax.enable_x64(True):
        want = jax.grad(lambda v: (jax_unpool(v, jnp.asarray(idx), (8, 8)) * weights).sum())(
            jnp.asarray(values, jnp.float64))
    grads = []
    for fn in (lambda v: F.max_unpool2d(v, nchw(idx).long(), 3, 2, 1, output_size=(8, 8)),
               lambda v: max_unpool(v, nchw(idx).long(), (8, 8))):
        tv = nchw(values.astype(np.float64)).requires_grad_()
        (fn(tv) * nchw(weights)).sum().backward()
        grads.append(nhwc(tv.grad))
    theirs, ours = grads
    assert not np.array_equal(theirs, np.asarray(want))
    np.testing.assert_array_equal(ours, np.asarray(want))
