"""The port's model utilities and summary against the JAX package on the
CPU: SWA, precise BN, the class weights, autoanchor k-means and its
best-possible recall, and the summary's parameter counts.

Tolerances: SWA bit for bit (both sum in the same order, then divide);
class weights, anchors and recall bit for bit (numpy on both sides, one
seed); precise BN's population statistics within 1e-5 relative of a
float64 computation from JAX's own BN inputs; parameter counts equal.
The summary's FLOPs are not compared: the port counts convolutions and
matmuls, XLA counts every operation.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.classification import Classification as JaxClassification
from cvpytorch_tpu.utils import model_utils as jax_mu
from cvpytorch_tpu.utils import summary as jax_summary_mod
from cvpytorch_tpu_torch.models.classification import Classification
from cvpytorch_tpu_torch.utils import model_utils as mu
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from cvpytorch_tpu_torch.utils.summary import format_summary, model_summary
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolov5 import make_pair as yolov5_pair

DICTIONARY = ({"a": 1.0}, {"b": 1.0}, {"c": 1.0})
TINY = {"BACKBONE": {"name": "TinyNet", "widths": [8, 16, 32]}}


def tiny_pair(seed=2):
    jm = JaxClassification(dictionary=DICTIONARY, model_cfg=TINY)
    x = np.zeros((2, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                            jnp.zeros(2, jnp.int32), mode="val"))
    variables = fill_tree(shapes, seed)
    tm = load_jax_variables(Classification(dictionary=DICTIONARY, model_cfg=TINY), variables)
    return jm, variables, tm


def batches(n=3, b=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": (rng.rand(b, 32, 32, 3) * (1 + 0.5 * i) + 0.2 * i).astype(np.float32),
             "target": rng.randint(0, 3, b).astype(np.int32)} for i in range(n)]


def test_swa_average_equals_jax():
    trees = [tiny_pair(seed)[1] for seed in (1, 2, 3)]
    want = jax_mu.swa_average([t["params"] for t in trees])
    want_stats = jax_mu.swa_average([t["batch_stats"] for t in trees])
    models = [load_jax_variables(Classification(dictionary=DICTIONARY, model_cfg=TINY), t)
              for t in trees]
    got = mu.swa_average(m.state_dict() for m in models)
    ref = load_jax_variables(Classification(dictionary=DICTIONARY, model_cfg=TINY),
                             {"params": want, "batch_stats": want_stats}).state_dict()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError):
        mu.swa_average([])


def test_precise_bn_gives_population_moments_and_jax_carries_bessel():
    """Each BN's population mean = E[batch mean], var = E[batch var +
    batch mean²] − mean² with the biased batch var, from the BN inputs of
    JAX's own train-mode forward taken in float64.  JAX's ``precise_bn``
    reads the repo's BatchNorm's running var, which holds the batch var
    times n/(n − 1): its var is that formula with the unbiased batch var."""
    jm, variables, tm = tiny_pair()
    bs = batches()
    jax_batches = [{"image": jnp.asarray(b["image"]), "target": jnp.asarray(b["target"])}
                   for b in bs]
    jout = jax_mu.precise_bn(jm, variables["params"], variables["batch_stats"], jax_batches)
    moments = {}
    for b in bs:
        _, inter = jm.apply(variables, jnp.asarray(b["image"]), jnp.asarray(b["target"]),
                            mode="train", mutable=["batch_stats", "intermediates"],
                            capture_intermediates=True)
        for name, stage in inter["intermediates"]["backbone"].items():
            if not name.startswith("stage"):
                continue
            x = np.asarray(stage["conv"]["__call__"][0], np.float64)
            n = x.size // x.shape[-1]
            moments.setdefault(name, []).append(
                (x.mean((0, 1, 2)), x.var((0, 1, 2)), n / (n - 1)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.eval()
    mu.precise_bn(tm, [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs])
    assert not tm.training
    for name, ms in moments.items():
        bm = np.mean([m for m, _, _ in ms], 0)
        biased = np.mean([v + m * m for m, v, _ in ms], 0) - bm * bm
        bessel = np.mean([v * f + m * m for m, v, f in ms], 0) - bm * bm
        bn = getattr(tm.backbone, name).bn
        np.testing.assert_allclose(bn.running_mean.numpy(), bm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), biased, rtol=1e-5, atol=1e-6)
        assert torch.equal(bn.num_batches_tracked,
                           before[f"backbone.{name}.bn.num_batches_tracked"])
        jbn = jout["backbone"][name]["bn"]
        np.testing.assert_allclose(np.asarray(jbn["mean"]), bm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jbn["var"]), bessel, rtol=1e-5, atol=1e-6)
        assert not np.allclose(biased, bessel, rtol=1e-4)
    for k, v in tm.state_dict().items():  # nothing but the BN statistics moved
        if "running_" not in k:
            assert torch.equal(v, before[k]), k


def test_class_weights_equal_jax():
    rng = np.random.RandomState(1)
    masks = [rng.randint(0, 6, (12, 20)) for _ in range(3)]
    masks[0][0, :5] = 255
    np.testing.assert_array_equal(mu.seg_class_weights(masks, 6),
                                  jax_mu.seg_class_weights(masks, 6))
    labels = [rng.randint(0, 5, 9) for _ in range(4)]
    np.testing.assert_array_equal(mu.det_class_weights(labels, 7),
                                  jax_mu.det_class_weights(labels, 7))


@pytest.mark.parametrize("seed", [0, 3])
def test_kmean_anchors_and_check_anchors_equal_jax(seed):
    rng = np.random.RandomState(seed)
    wh = np.concatenate([rng.rand(80, 2) * 5 + 10, rng.rand(80, 2) * 40 + 60,
                         rng.rand(80, 2) * 200 + 150, rng.rand(5, 2)])
    got = mu.kmean_anchors(wh, n=9, iters=30, seed=seed)
    want = jax_mu.kmean_anchors(wh, n=9, iters=30, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert mu.check_anchors(wh, got) == jax_mu.check_anchors(wh, want)


@pytest.mark.parametrize("which", ["yolov5_n", "classification"])
def test_summary_parameter_counts_equal_jax(which):
    """The classifier through JAX's whole ``model_summary``; YOLOv5-n
    through its parameter count of the tree (XLA compiles a detector's
    forward for the FLOPs in ~20 s)."""
    if which == "yolov5_n":
        jm, variables, tm = yolov5_pair("yolov5_n", seed=0)
        shape = (1, 64, 64, 3)
        by_module = jax_summary_mod._tree_param_counts(variables["params"])
        want = {"total_params": sum(by_module.values()), "params_by_module": by_module}
    else:
        jm, _, tm = tiny_pair()
        shape = (1, 32, 32, 3)
        want = jax_summary_mod.model_summary(jm, shape)
    got = model_summary(copy.deepcopy(tm).eval(), shape)
    assert got["total_params"] == want["total_params"]
    assert got["params_by_module"] == want["params_by_module"]
    assert got["flops"] > 0 and "flop_counter" in got["flops_basis"]
    text = format_summary(got, which)
    assert "TOTAL params" in text and "forward FLOPs" in text
