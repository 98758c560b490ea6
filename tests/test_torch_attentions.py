"""The port's attention blocks against the JAX package's on the CPU, one
set of seeded weights carried by ``load_jax_variables``: outputs in
float32 within 1e-5 of their largest value, and the input gradient of a
fixed projection in float64 within 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import attentions as ja
from cvpytorch_tpu_torch.models import attentions as ta
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

C = 32
CASES = {  # name → (JAX module, port module)
    "SEAttention": (ja.SEAttention(reduction=4), lambda: ta.SEAttention(C, 4)),
    "cSEBlock": (ja.cSEBlock(reduction=8), lambda: ta.cSEBlock(C, 8)),
    "sSEBlock": (ja.sSEBlock(), lambda: ta.sSEBlock(C)),
    "scSEBlock": (ja.scSEBlock(reduction=4), lambda: ta.scSEBlock(C, 4)),
    "SimAM": (ja.SimAM(), lambda: ta.SimAM()),
    "ChannelAttentionModule": (ja.ChannelAttentionModule(reduction=4),
                               lambda: ta.ChannelAttentionModule(C, 4)),
    "SpatialAttentionModule": (ja.SpatialAttentionModule(), lambda: ta.SpatialAttentionModule()),
    "CBAM": (ja.CBAM(reduction=8), lambda: ta.CBAM(C, 8)),
    "ECAAttention": (ja.ECAAttention(kernel_size=5), lambda: ta.ECAAttention(5)),
}


def pair(name, x):
    jm, make = CASES[name]
    variables = init_tree(jm, jnp.asarray(x), seed=2) if name != "SimAM" else {}
    tm = make()
    if variables:
        load_jax_variables(tm, variables)
    return jm, variables, tm


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_jax(name):
    x = (np.random.RandomState(0).randn(2, 7, 9, C) * 2).astype(np.float32)
    jm, variables, tm = pair(name, x)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    w = np.random.RandomState(1).randn(*x.shape)
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        jg = np.asarray(jax.grad(lambda a: jnp.sum(jm.apply(v64, a) * w))(jnp.asarray(x64)))
    xt = torch.from_numpy(x64).permute(0, 3, 1, 2).requires_grad_()
    (tm.double()(xt).permute(0, 2, 3, 1) * torch.from_numpy(w)).sum().backward()
    tg = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.abs(tg - jg).max() <= 1e-9 * np.abs(jg).max()
