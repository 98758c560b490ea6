"""The seven backbones the port took last (ConvNeXt, RegNet, MobileNetV3,
TinyNet, SqueezeNet 1.1, DenseNet, ViT) against the JAX modules on the
CPU, one set of seeded weights carried by ``load_jax_variables``.

Tolerance: eval-mode outputs in float32 within 1e-4 of their largest
value, in classifier and feature modes, at 32² (ViT-B/16 and DenseNet-121
too).  The train-mode gradients: ``tests/test_torch_extra_backbone_grads.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones import convnext as j_convnext
from cvpytorch_tpu.models.backbones import misc_backbones as j_misc
from cvpytorch_tpu.models.backbones import mobilenetv3 as j_mbv3
from cvpytorch_tpu.models.backbones import regnet as j_regnet
from cvpytorch_tpu.models.backbones import tinynet as j_tinynet
from cvpytorch_tpu_torch.models.backbones import build_backbone
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

HW = 32
GRAD_HW = 64  # the last stages' train-mode BN over 2 samples of 1×1 maps is ill-conditioned

# name → (JAX class, port registry name, kwargs of both, port-only kwargs;
# ViT's img_size, which Flax reads off the input, is the input's side)
CASES = {
    "convnext_t": (j_convnext.ConvNeXt, "ConvNeXt", {"subtype": "convnext_tiny"}, {}),
    "regnet_y_400mf": (j_regnet.RegNet, "RegNet", {"subtype": "regnet_y_400mf"}, {}),
    "regnet_x_400mf": (j_regnet.RegNet, "regnet", {"subtype": "regnet_x_400mf"}, {}),
    "mobilenet_v3_large": (j_mbv3.MobileNetV3, "MobileNetV3", {}, {}),
    "mobilenet_v3_small": (j_mbv3.MobileNetV3, "mobilenet_v3",
                           {"subtype": "mobilenet_v3_small"}, {}),
    "tinynet": (j_tinynet.TinyNet, "TinyNet", {}, {}),
    "squeezenet1_1": (j_misc.SqueezeNet, "squeezenet", {}, {}),
    "densenet121": (j_misc.DenseNet, "DenseNet", {}, {}),
    "vit_b_16": (j_misc.ViT, "VisionTransformer", {}, {"img_size": None}),
    "vit_t_16": (j_misc.ViT, "vit", {"subtype": "vit_t_16"}, {"img_size": None}),
}
# train-mode settings that keep JAX's RNG out (dropout, stochastic depth)
NO_DROP = {"convnext_t": {"drop_path_rate": 0.0}, "mobilenet_v3_large": {"dropout": 0.0},
           "mobilenet_v3_small": {"dropout": 0.0}}


def images(seed=0, b=2, hw=HW):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


def make_pair(case, classifier, extra=None, seed=3, hw=HW):
    jcls, name, kw, port_kw = CASES[case]
    kw = {**kw, "classifier": classifier, "num_classes": 7, **(extra or {})}
    jm = jcls(**kw)
    variables = init_tree(jm, jnp.asarray(images(hw=hw)), seed=seed)
    port_kw = {k: hw if v is None else v for k, v in port_kw.items()}
    tm = build_backbone({"name": name, **kw, **port_kw})
    return jm, variables, load_jax_variables(tm, variables)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy() if t.dim() == 4 else t.detach().numpy()


def assert_close_to_scale(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("classifier", [True, False], ids=["classifier", "features"])
@pytest.mark.parametrize("case", list(CASES))
def test_eval_forward_matches_jax(case, classifier):
    jm, variables, tm = make_pair(case, classifier)
    x = images(seed=1)
    want = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    if classifier:
        assert got.shape == (2, 7)
        assert_close_to_scale(got.numpy(), want, 1e-4)
        return
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert_close_to_scale(nhwc(g), w, 1e-4)


def test_constructor_defaults_follow_jax():
    """The registry's names and aliases, the JAX modules' default
    subtypes and stages, the LayerNorms' Flax eps and ConvNeXt's
    stochastic-depth schedule."""
    tm = build_backbone({"name": "convnext"})
    assert tm.out_stages == (2, 3, 4) and not tm.classifier
    assert tm.stage1_block0.norm.eps == 1e-6 and tm.stem_norm.eps == 1e-6
    assert tm.stage1_block0.drop.rate == 0.0
    assert abs(tm.stage4_block2.drop.rate - 0.1) < 1e-12
    assert build_backbone({"name": "regnet"}).stage1_block0.se is not None  # Y: SE
    assert len(build_backbone({"name": "MobileNetV3"}).stages) == 6  # large
    vit = build_backbone({"name": "ViT"})
    assert vit.classifier and vit.pos_embed.shape == (1, 197, 768)
    assert build_backbone({"name": "DenseNet"}).channels == [128, 256, 512, 1024]
