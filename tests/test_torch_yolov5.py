"""The port's YOLOv5 (``cvpytorch_tpu_torch/models``) against the JAX
package on the CPU, float32, with one set of weights carried across by
``load_jax_variables``.

The weights fill the JAX model's own variable tree (its shapes from
``jax.eval_shape`` of ``init``) with seeded numpy draws: lecun-normal
kernels, and BN scale/bias/mean/var drawn away from their identity init so
that the BatchNorm mapping is exercised too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.detects.yolov5_detect import decode_yolov5 as jdecode
from cvpytorch_tpu.models.yolov5 import DEFAULT_ANCHORS, STRIDES
from cvpytorch_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from cvpytorch_tpu_torch.models.detects.yolov5_detect import decode_yolov5
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.utils.porting import load_jax_variables

DICTIONARY = tuple({f"class{i}": 1.0} for i in range(3))
# f32 forward through ~60 conv+BN layers: the two frameworks sum in other
# orders.  Measured max |diff| on these inputs: stem 9.5e-7, backbone
# 3.3e-7, neck 1.5e-7, raw maps 2.7e-7 (yolov5_n 64², yolov5_s 32²)
ATOL = RTOL = 1e-4


def jax_variables(jax_model, seed: int, hw=(64, 64)):
    """A {'params', 'batch_stats'} tree of numpy arrays for ``jax_model``."""
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)),
        method=lambda m, x: m._raw(x, False)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_pair(subtype="yolov5_n", seed=0, hw=(64, 64)):
    cfg = {"TYPE": subtype}
    jm = JaxYOLOv5(dictionary=DICTIONARY, model_cfg=cfg)
    variables = jax_variables(jm, seed, hw)
    tm = load_jax_variables(YOLOv5(dictionary=DICTIONARY, model_cfg=cfg),
                            variables).eval()
    return jm, variables, tm


def images(seed, B=2, hw=(64, 64)):
    return np.random.RandomState(100 + seed).rand(B, *hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def pair_n():
    return make_pair("yolov5_n", seed=0)


def test_stem_6x6_matches_space_to_depth_stem(pair_n):
    jm, variables, tm = pair_n
    x = images(0)
    _, inter = jm.apply(variables, jnp.asarray(x),
                        method=lambda m, v: m._raw(v, False),
                        capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["backbone"]["stem"]["__call__"][0])
    with torch.no_grad():
        got = tm.backbone.stem(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("subtype,hw", [("yolov5_n", (64, 64)),
                                        ("yolov5_s", (32, 32))])
def test_backbone_neck_and_raw_maps_match(subtype, hw):
    jm, variables, tm = (make_pair(subtype, seed=1, hw=hw)
                         if subtype != "yolov5_n" else make_pair(seed=1))
    x = images(1, hw=hw)
    jraw, inter = jm.apply(variables, jnp.asarray(x),
                           method=lambda m, v: m._raw(v, False),
                           capture_intermediates=True)
    inter = inter["intermediates"]
    with torch.no_grad():
        feats = tm.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        necks = tm.neck(feats)
        raw = tm.detect(necks)
    for got, want in zip(feats, inter["backbone"]["__call__"][0]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=RTOL)
    for got, want in zip(necks, inter["neck"]["__call__"][0]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=RTOL)
    for got, want in zip(raw, jraw):
        assert tuple(got.shape) == want.shape  # (B, ny, nx, A, 5+C)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


def test_decode_matches():
    rng = np.random.RandomState(2)
    raw = [rng.randn(2, s, s, 3, 8).astype(np.float32) * 2 for s in (8, 4, 2)]
    want = np.asarray(jdecode([jnp.asarray(r) for r in raw],
                              DEFAULT_ANCHORS, STRIDES))
    got = decode_yolov5([torch.from_numpy(r) for r in raw],
                        DEFAULT_ANCHORS, STRIDES).numpy()
    assert got.shape == want.shape == (2, (64 + 16 + 4) * 3, 8)
    # sigmoid implementations differ in the last bits; pixels up to ~1e3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_infer_mode_matches_jax(pair_n):
    """Labels, valid and num exactly; boxes and scores within 1e-4.  The
    seed matters: where two candidate scores lie closer than the frameworks'
    f32 disagreement (~1e-6 relative), their order can swap."""
    jm, variables, tm = pair_n
    x = images(0)
    jd = jm.apply(variables, jnp.asarray(x), mode="infer")
    with torch.no_grad():
        td = tm(torch.from_numpy(x), mode="infer")
    for key in ("labels", "valid", "num"):
        assert np.array_equal(td[key].numpy(), np.asarray(jd[key])), key
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]),
                                   atol=1e-4, rtol=1e-4)
    assert int(td["num"].min()) > 0


def test_loader_is_strict(pair_n):
    jm, variables, _ = pair_n
    fresh = lambda: YOLOv5(dictionary=DICTIONARY, model_cfg={"TYPE": "yolov5_n"})
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["params"]["detect"]["m2"]["bias"]
    with pytest.raises(KeyError, match="detect.m2.bias"):
        load_jax_variables(fresh(), missing)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["batch_stats"]["neck"]["up1"]["reduce"]["bn"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError, match="up1/reduce/bn/extra"):
        load_jax_variables(fresh(), extra)
    wrong = jax.tree_util.tree_map(lambda a: a, variables)
    wrong["params"]["backbone"]["sppf"]["conv1"]["bn"]["scale"] = np.ones(7)
    with pytest.raises(KeyError, match="shape mismatch"):
        load_jax_variables(fresh(), wrong)
