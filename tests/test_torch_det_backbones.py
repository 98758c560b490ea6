"""The port's detection backbones of NanoDet v1 (RepVGG, EfficientNet-Lite,
CustomCspNet) and YOLOv6's EfficientRep against the JAX package on the
CPU, with one set of weights carried across by ``load_jax_variables``.

Tolerances: every output within 1e-4 of its largest value in eval mode
(float32); in train mode (BN on the batch's statistics) every output
and the running statistics it leaves within 1e-9 of their largest value
in float64 on both sides: BN over the few values of a deep level's
small map puts float32 train-mode outputs of random-weight networks
1e-4 to 1e-3 apart (JAX's own float32 against its float64 likewise;
ROADMAP's known trap), while float64 agrees to 1e-13.  RepVGG's
fused blocks equal the unfused ones in eval mode within 1e-4 of the
output's largest value, and the fused kernels equal the JAX
``fuse_repvgg_kernel``'s within 1e-5 of their largest value.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones import custom_cspnet as jax_csp
from cvpytorch_tpu.models.backbones import efficientnet_lite as jax_lite
from cvpytorch_tpu.models.backbones import repvgg as jax_repvgg
from cvpytorch_tpu.models import yolov6 as jax_yolov6
from cvpytorch_tpu_torch.models import yolov6
from cvpytorch_tpu_torch.models.backbones.custom_cspnet import CustomCspNet
from cvpytorch_tpu_torch.models.backbones.efficientnet_lite import EfficientNetLite
from cvpytorch_tpu_torch.models.backbones.repvgg import RepVGG, RepVGGBlock, fuse_repvgg_kernel
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


def images(hw, seed=0):
    return np.random.RandomState(seed).rand(B, hw, hw, 3).astype(np.float32)


def check_both_modes(jm, tm, x, seed=5):
    """Eval mode in float32, and train mode with the running statistics it
    leaves in float64, against JAX (each side of JAX one jitted call)."""
    variables = init_tree(jm, jnp.asarray(x), seed=seed)
    tm = load_jax_variables(tm, variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w)
    as64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        want, new_vars = jax.jit(lambda v, a: jm.apply(v, a, train=True,
                                                        mutable=["batch_stats"]))(
            as64, jnp.asarray(x, jnp.float64))
        want = [np.asarray(w) for w in want]
        new_stats = jax.tree_util.tree_map(np.asarray, new_vars["batch_stats"])
    trained = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        got = trained(nchw(x).double())
    for g, w in zip(got, want):
        assert_close_to_scale(g.permute(0, 2, 3, 1).numpy(), w, 1e-9)
    want_stats = load_jax_variables(copy.deepcopy(tm).double(),
                                    {**as64, "batch_stats": new_stats}).state_dict()
    for k, v in trained.state_dict().items():
        if "running" in k:
            assert_close_to_scale(v.numpy(), want_stats[k].numpy(), 1e-9)
    return tm


@pytest.mark.parametrize("subtype,out_stages,hw", [("RepVGG-A0", (2, 3, 4), 64),
                                                   ("RepVGG_B1g2", (1, 2, 3, 4), 32)])
def test_repvgg_matches_jax(subtype, out_stages, hw):
    """A0 (NanoDet's config) and a grouped gN variant; stage 4 is 512 wide."""
    x = images(hw)
    tm = check_both_modes(jax_repvgg.RepVGG(subtype=subtype, out_stages=out_stages),
                          RepVGG(subtype=subtype, out_stages=out_stages), x)
    assert tm.out_channels[-1] == 512
    assert [f.shape[1] for f in tm(nchw(x))] == tm.out_channels


def test_repvgg_classifier_matches_jax():
    x = images(32)
    jm = jax_repvgg.RepVGG(subtype="RepVGG-A0", classifier=True, num_classes=7)
    variables = init_tree(jm, jnp.asarray(x), seed=2)
    tm = load_jax_variables(RepVGG(subtype="RepVGG-A0", classifier=True, num_classes=7),
                            variables).eval()
    with torch.no_grad():
        assert_close_to_scale(tm(nchw(x)).numpy(), jm.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("stride,cin,cout,groups", [(1, 16, 16, 1), (2, 16, 24, 1),
                                                    (1, 16, 16, 2)])
def test_repvgg_fused_equals_unfused(stride, cin, cout, groups):
    """``fuse_repvgg_kernel`` folds the three branches: the one 3×3
    convolution equals the train-form block in eval mode, and (ungrouped)
    its kernel and bias equal JAX's ``fuse_repvgg_kernel``."""
    x = np.random.RandomState(1).randn(B, 9, 9, cin).astype(np.float32)
    jm = jax_repvgg.RepVGGBlock(cout, stride, groups=groups)
    variables = init_tree(jm, jnp.asarray(x), seed=3)
    block = load_jax_variables(RepVGGBlock(cin, cout, stride, groups=groups), variables).eval()
    fused = RepVGGBlock(cin, cout, stride, deploy=True, groups=groups).eval()
    weight, bias = fuse_repvgg_kernel(block)
    with torch.no_grad():
        fused.reparam.weight.copy_(weight)
        fused.reparam.bias.copy_(bias)
        want = block(nchw(x))
        assert_close_to_scale(fused(nchw(x)).numpy(), want.numpy())
    assert_close_to_scale(want.permute(0, 2, 3, 1).numpy(), jm.apply(variables, jnp.asarray(x)))
    if groups == 1:
        k, b = jax_repvgg.fuse_repvgg_kernel(variables["params"], variables["batch_stats"],
                                             cin, cout, stride == 1 and cin == cout)
        assert_close_to_scale(weight.numpy(), k.transpose(3, 2, 0, 1), 1e-5)
        assert_close_to_scale(bias.numpy(), b, 1e-5)


def test_efficientnet_lite_matches_jax():
    """lite0 at NanoDet's ``out_stages`` [2, 4, 6]: widths 40, 112, 320."""
    x = images(64)
    tm = check_both_modes(jax_lite.EfficientNetLite(subtype="efficientnet_lite0",
                                                    out_stages=(2, 4, 6)),
                          EfficientNetLite("efficientnet_lite0", out_stages=(2, 4, 6)), x)
    assert tm.out_channels == [40, 112, 320]


@pytest.mark.parametrize("subtype", ["efficientnet_lite1", "efficientnet_lite2"])
def test_efficientnet_lite_scaled_variants_match_jax(subtype):
    """Depth- and width-scaled variants and the classifier: the logits."""
    x = images(32)
    jm = jax_lite.EfficientNetLite(subtype=subtype, classifier=True, num_classes=5)
    variables = init_tree(jm, jnp.asarray(x), seed=4)
    tm = load_jax_variables(EfficientNetLite(subtype, classifier=True, num_classes=5),
                            variables).eval()
    with torch.no_grad():
        assert_close_to_scale(tm(nchw(x)).numpy(), jm.apply(variables, jnp.asarray(x)))


def test_custom_cspnet_matches_jax():
    """NanoDet-g's ``out_stages`` [3, 4, 5]: widths 128, 256, 512."""
    x = images(64)
    tm = check_both_modes(jax_csp.CustomCspNet(out_stages=(3, 4, 5)),
                          CustomCspNet(out_stages=(3, 4, 5)), x)
    assert tm.out_channels == [128, 256, 512]


@pytest.mark.parametrize("sppf", ["simcsp", "relu"])
def test_efficient_rep_matches_jax(sppf):
    """yolov6_n's multipliers (depth 0.33, width 0.25), four levels out,
    either pyramid pool."""
    x = images(64)
    tm = check_both_modes(
        jax_yolov6.EfficientRep(depth_mul=0.33, width_mul=0.25, out_stages=(1, 2, 3, 4),
                                sppf=sppf),
        yolov6.EfficientRep(depth_mul=0.33, width_mul=0.25, out_stages=(1, 2, 3, 4),
                            sppf=sppf), x)
    assert tm.out_channels == [32, 64, 128, 256]
