"""The port's int8 post-training quantization against the JAX package on
the CPU.

Tolerances: int8 payloads and float32 scales equal bit for bit, layer by
layer, after the weight carry's layout map (conv, transposed conv, Dense,
a Dense held by a 1×1 conv, the attention projections, a position
embedding); ``fake_quant`` forward and straight-through gradient equal;
calibrated activation scales and ``quantized_apply``'s logits within 1e-5
relative of JAX's; the round-tripped model's logits within 1e-5 of the
JAX model's on the same round-tripped weights.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvpytorch_tpu.models.backbones.tinynet import TinyNet as JaxTinyNet
from cvpytorch_tpu.utils import quantize as jq
from cvpytorch_tpu_torch.models.backbones.tinynet import TinyNet
from cvpytorch_tpu_torch.models.necks.tan import MultiHeadAttention
from cvpytorch_tpu_torch.utils import quantize as q
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables, port_name
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)


class _JaxLayouts(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.Conv(8, (3, 3), name="conv")(x)
        h = fnn.ConvTranspose(6, (2, 2), strides=(2, 2), name="deconv")(h)
        h = fnn.Dense(6, name="linear")(h)  # the port holds it as a 1×1 conv
        t = h.reshape(h.shape[0], -1, 6)
        t = fnn.MultiHeadDotProductAttention(num_heads=2, name="attn")(t)
        t = t + self.param("pos_embed", fnn.initializers.normal(0.02), (1, t.shape[1], 6))
        return fnn.Dense(5, name="fc")(t.mean(1))


class _PortLayouts(torch.nn.Module):
    def __init__(self, tokens):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.deconv = torch.nn.ConvTranspose2d(8, 6, 2, 2)
        self.linear = torch.nn.Conv2d(6, 6, 1)
        self.attn = MultiHeadAttention(6, 2)
        self.pos_embed = torch.nn.Parameter(torch.zeros(1, tokens, 6))
        self.fc = torch.nn.Linear(6, 5)


def test_int8_payloads_equal_jax_leaf_by_leaf():
    x = np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32)
    variables = init_tree(_JaxLayouts(), jnp.asarray(x), seed=1)
    tm = load_jax_variables(_PortLayouts(64), variables)
    want = jq.quantize_tree(variables["params"])
    got = q.quantize_tree(tm)
    owners, params = dict(tm.named_modules()), dict(tm.named_parameters())
    quantized = set()
    leaves = dict(_flatten(want))
    for path, leaf in leaves.items():
        if path[-1] == "scale" and path[:-1] + ("q",) in leaves:
            continue
        if path[-1] == "q":  # (..., module, leaf, 'q')
            name = port_name("params", path[:-1], params)
            entry = got[name]
            assert entry["q"].dtype == torch.int8
            as_port = _convert(name, leaf.astype(np.float32), params[name],
                               owners.get(".".join(path[:-2])))
            np.testing.assert_array_equal(entry["q"].numpy(), as_port.astype(np.int8), name)
            jscale = leaves[path[:-1] + ("scale",)]
            np.testing.assert_array_equal(entry["scale"].numpy(), jscale, name)
            quantized.add(name)
        else:
            name = port_name("params", path, params)
            assert torch.is_tensor(got[name]), name  # left in float, as in JAX
    assert quantized == {n for n, v in got.items() if isinstance(v, dict)}
    assert {"attn.query.bias", "attn.out.weight", "deconv.weight", "linear.weight",
            "pos_embed"} <= quantized
    assert "attn.out.bias" not in quantized and "fc.bias" not in quantized
    back = q.dequantize_tree(got)
    assert all(back[n].shape == p.shape for n, p in params.items())


def tiny_pair():
    x = np.random.RandomState(2).rand(4, 24, 24, 3).astype(np.float32)
    jm = JaxTinyNet(widths=(8, 12, 16), classifier=True, num_classes=5)
    variables = init_tree(jm, jnp.asarray(x), seed=3)
    tm = load_jax_variables(TinyNet(widths=(8, 12, 16), classifier=True, num_classes=5),
                            variables).eval()
    return jm, variables, tm, x


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_ptq_roundtrip_equals_jax():
    jm, variables, tm, x = tiny_pair()
    jparams = jq.ptq_roundtrip(variables["params"])
    want = jm.apply({"params": jparams, "batch_stats": variables["batch_stats"]},
                    jnp.asarray(x))
    ref = load_jax_variables(copy.deepcopy(tm), {"params": jparams,
                                                 "batch_stats": variables["batch_stats"]})
    q.ptq_roundtrip(tm)
    for (n, p), (_, r) in zip(tm.named_parameters(), ref.named_parameters()):
        assert torch.equal(p, r), n
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()


def test_fake_quant_forward_and_straight_through_gradient():
    rng = np.random.RandomState(4)
    x = (rng.randn(500) * 3).astype(np.float32)
    w = rng.randn(500).astype(np.float32)
    scale = float(np.abs(x).max() / 127.0) * 0.8  # some values outside the range
    want = jq.fake_quant(jnp.asarray(x), scale)
    want_g = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, scale) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = q.fake_quant(xt, scale)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert (xt.grad.numpy() == 0).any()


def test_calibration_and_quantized_apply_equal_jax():
    jm, variables, tm, x = tiny_pair()
    batches = [x[:2], x[2:]]
    want = jq.calibrate_activations(jm, variables, [jnp.asarray(b) for b in batches])
    got = q.calibrate_activations(tm, [nchw(b) for b in batches])
    assert set(got) == set(want) and "" in got and "stage1/bn" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    jout = np.asarray(jq.quantized_apply(jm, variables, jnp.asarray(x), act_scales=want))
    with torch.no_grad():
        tout = q.quantized_apply(tm, nchw(x), act_scales=want).numpy()
        plain = tm(nchw(x)).numpy()
    assert np.abs(tout - jout).max() <= 1e-5 * np.abs(jout).max()
    assert np.abs(tout - plain).max() > 1e-4 * np.abs(plain).max()  # int8 moved it
    xt = nchw(x).requires_grad_()  # differentiable: the same call serves QAT
    q.quantized_apply(tm, xt, act_scales=want).sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert not any(m._forward_hooks for m in tm.modules())


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_kernel_bounds_the_error(axis):
    w = torch.from_numpy(np.random.RandomState(5).randn(16, 8, 3, 3).astype(np.float32))
    qw, s = q.quantize_kernel(w, axis)
    assert qw.dtype == torch.int8 and s.shape == (w.shape[axis],)
    back = q.dequantize_kernel(qw, s, axis)
    shape = [1] * 4
    shape[axis] = -1
    assert ((back - w).abs() <= s.reshape(shape) * 0.51).all()
