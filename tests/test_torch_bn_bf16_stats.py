"""``AMP_BN_BF16_STATS`` in the port against the JAX package on the CPU.

XLA takes a bfloat16 mean as a float32 sum divided by n in float32,
rounded to bfloat16 (the jaxpr: convert, reduce_sum, div, convert); the
square x·x is rounded to bfloat16 first and var = max(E[x²] − mean², 0)
is bfloat16 arithmetic.  ``bricks.bf16_batch_moments`` does the same with
torch's float32 sums, whose order differs: the moments agree to within one
bfloat16 ulp of the value (mean) or of E[x²] (var, where the subtraction
cancels).  Through a BN in train mode under autocast the running
statistics agree within one bfloat16 ulp of the increment they take (a
tenth of the batch moment at momentum 0.1: JAX rounds that increment to
bfloat16, the port adds it in float32), and
the outputs within 2⁻⁶ of their largest value (JAX normalises in
bfloat16, the port in float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import normalization as fnorm

from cvpytorch_tpu.models.bricks import BatchNorm as JaxBatchNorm
from cvpytorch_tpu_torch.models.bricks import BatchNorm2d, bf16_batch_moments, set_bn_bf16_stats
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ULP = 2.0 ** -7  # bfloat16's spacing relative to a value in [1, 2)


def ulp(v):
    """One bfloat16 ulp at |v|."""
    return ULP * 2.0 ** np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))


def inputs(seed, shape=(4, 12, 10, 24)):
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.1, 4, shape[-1])
    return (rng.randn(*shape) * scale + rng.randn(shape[-1]) * 2).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moments_equal_xla_within_one_ulp(seed):
    x = inputs(seed)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jm, jv = fnorm._compute_stats(xb, (0, 1, 2), None, force_float32_reductions=False)
    assert jm.dtype == jv.dtype == jnp.bfloat16
    tm, tv = bf16_batch_moments(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tm.dtype == tv.dtype == torch.bfloat16
    jm, jv = (np.asarray(a.astype(jnp.float32)) for a in (jm, jv))
    tm, tv = tm.float().numpy(), tv.float().numpy()
    assert (np.abs(tm - jm) <= ulp(jm)).all()
    m2 = np.asarray((xb * xb).astype(jnp.float32)).mean((0, 1, 2))
    assert (np.abs(tv - jv) <= ulp(m2)).all()


def test_train_mode_bn_equals_jax_with_the_switch(monkeypatch):
    x = inputs(3)
    jbn = JaxBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    rng = np.random.RandomState(4)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
                            "bias": rng.randn(24).astype(np.float32) * 0.1},
                 "batch_stats": {"mean": rng.randn(24).astype(np.float32) * 0.1,
                                 "var": rng.uniform(0.5, 1.5, 24).astype(np.float32)}}
    monkeypatch.setenv("CVT_BN_BF16_STATS", "1")
    bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                                  variables["params"])
    jy, mutated = jbn.apply({"params": bf16, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x).astype(jnp.bfloat16), mutable=["batch_stats"])
    monkeypatch.delenv("CVT_BN_BF16_STATS")
    bn = BatchNorm2d(24, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    set_bn_bf16_stats(bn, True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        ty = bn(xt)
    assert ty.dtype == torch.bfloat16
    bm, bv = (m.float().numpy() for m in bf16_batch_moments(xt))
    n = x.size // 24
    for key, got, moment in (("mean", bn.running_mean, bm),
                             ("var", bn.running_var, bv * n / (n - 1))):
        want = np.asarray(mutated["batch_stats"][key])
        assert (np.abs(got.numpy() - want) <= 0.1 * ulp(moment) + 1e-7).all(), key
    jy = np.asarray(jy.astype(jnp.float32))
    ty = ty.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(ty - jy).max() <= 2.0 ** -6 * np.abs(jy).max()


def test_switch_acts_only_in_train_mode_under_autocast():
    """Off, eval or without autocast the BN is ``nn.BatchNorm2d``'s; the
    switch is set per model, and raises for another BN class when on."""
    x = torch.from_numpy(inputs(5)).permute(0, 3, 1, 2)
    plain = BatchNorm2d(24).train()
    switched = set_bn_bf16_stats(BatchNorm2d(24).train(), True)
    assert torch.equal(switched(x), plain(x))  # no autocast: float32 moments
    with torch.autocast("cpu", dtype=torch.bfloat16):
        a, b = switched(x.bfloat16()), plain(x.bfloat16())
    assert not torch.equal(switched.running_var, plain.running_var)
    assert a.dtype == b.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="BatchNorm2d"):
        set_bn_bf16_stats(torch.nn.Sequential(torch.nn.BatchNorm1d(3)), True)
    set_bn_bf16_stats(torch.nn.Sequential(torch.nn.BatchNorm1d(3)), False)
    assert "CVT_BN_BF16_STATS" not in os.environ
