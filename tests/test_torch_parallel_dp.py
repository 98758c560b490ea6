"""The port's data parallelism at W = 2 over gloo, on the CPU.

Two ranks spawned once for the file (``tests/torch_dp_ranks.py``: they
import the port only), each call with its own timeout.  Each case holds
the two ranks against one process on the global batch and, where the JAX
package has the counterpart, against JAX on a ``create_mesh(data=2)`` mesh
of two of the 8 CPU devices ``tests/conftest.py`` gives it:
``process_batch_slice`` and ``allgather_pickled``; the bricks' BN with
global moments; the YOLOv5 loss with every positive on rank 0; one
float32 train step of YOLOv5-n at 64² with EMA; a narrow UNet step; the
evaluators' merges in the single-process order (COCO and VOC with
cross-image score ties; seg, cls and keypoint); ``Trainer.run()`` at W = 2
against W = 1 with ``DEVICE_AUG``; and the refusals.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.evaluator.coco import CocoEvaluator as JaxCocoEvaluator
from cvpytorch_tpu.models.bricks import BatchNorm as JaxBatchNorm
from cvpytorch_tpu.optim.optimizers import build_optimizer as jax_build_optimizer
from cvpytorch_tpu.optim.schedules import build_lr_scheduler as jax_build_lr
from cvpytorch_tpu.parallel import mesh as pmesh
from cvpytorch_tpu.train_state import TrainState as JaxTrainState
from cvpytorch_tpu.train_state import make_train_step as jax_make_train_step
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models.bricks import BatchNorm2d
from cvpytorch_tpu_torch.models.losses.yolov5_loss import YOLOv5Loss
from cvpytorch_tpu_torch.models.yolov5 import DEFAULT_ANCHORS
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
from cvpytorch_tpu_torch.registry import EVALUATORS
from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step
from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten
from tests import torch_dp_ranks as ranks_mod
from tests.test_torch_train_loss import loss_inputs, one_torch_thread, pixel_targets  # noqa: F401
from tests.test_torch_train_step import EMA_DECAY, RECIPE, START, assert_tree_close
from tests.test_torch_train_trainer import DEVICE_AUG, VAL_64, write_config
from tests.test_torch_yolov5 import images, jax_variables, make_pair

W = 2


@pytest.fixture(scope="module")
def ranks():
    pool = ranks_mod.RankPool(W)
    yield pool
    pool.close()


@pytest.fixture(autouse=True)
def jax_default_path(monkeypatch):
    monkeypatch.delenv("CVT_OBJ_SLICE", raising=False)
    monkeypatch.delenv("CVT_BN_BF16_STATS", raising=False)


def jax_mesh():
    return pmesh.create_mesh(data=W, devices=jax.devices()[:W])


def test_process_helpers_match_jax(ranks):
    """Rank r's rows of a global batch of 8 are [4r, 4r + 4), together
    JAX's one-process slice; a batch of 9 raises; the gathered objects,
    in rank order, are what JAX's one-process gather returns for each."""
    obj = {"x": np.arange(3)}
    out = ranks.run("job_process_helpers", 8, obj, timeout=30)
    want = pmesh.process_batch_slice(8)
    rows = [r for o in out for r in range(*o["slice"])]
    assert rows == list(range(want.start, want.stop))
    assert [o["slice"] for o in out] == [(0, 4), (4, 8)]
    assert all("not divisible by 2 ranks" in o["odd"] for o in out)
    assert [o["main"] for o in out] == [True, False]
    assert all(o["local_devices"] == W for o in out)
    for o in out:
        assert [g["rank"] for g in o["gathered"]] == [0, 1]
        for g in o["gathered"]:
            (jax_obj,) = pmesh.allgather_pickled(obj)
            np.testing.assert_array_equal(g["x"], jax_obj["x"])


def _bn_inputs(seed=0, B=8, C=4, hw=5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, C, hw, hw) * 3 + 2).astype(np.float32)
    return (x, rng.rand(C).astype(np.float32) + 0.5, rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32), rng.rand(C).astype(np.float32) + 0.5,
            rng.randn(B, C, hw, hw).astype(np.float32))


def test_bn_global_moments_match_one_process_and_jax_mesh(ranks):
    """Two train-mode forwards on each rank's half: the output, the input
    and affine gradients and the running mean and variance (global
    Bessel factor) within 1e-5 of the bricks' BN on the whole batch, and of
    the JAX BatchNorm on a data=2 mesh (output and running statistics)."""
    x, weight, bias, mean, var, g = _bn_inputs()
    m = 0.03
    out = ranks.run("job_bn", x, weight, bias, mean, var, m, g, timeout=30)

    bn = BatchNorm2d(x.shape[1], eps=1e-3, momentum=m).train()
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    for _ in range(2):
        y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([o["y"] for o in out]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([o["x_grad"] for o in out]), xt.grad.numpy(),
                               **tol)
    for o in out:
        np.testing.assert_allclose(o["w_grad"], bn.weight.grad.numpy(), **tol)
        np.testing.assert_allclose(o["b_grad"], bn.bias.grad.numpy(), **tol)
        np.testing.assert_allclose(o["running_mean"], bn.running_mean.numpy(), **tol)
        np.testing.assert_allclose(o["running_var"], bn.running_var.numpy(), **tol)
        assert o["tracked"] == 2

    jbn = JaxBatchNorm(momentum=1 - m, epsilon=1e-3, use_running_average=False)
    variables = {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}

    @jax.jit
    def two_steps(variables, xs):
        y, upd = jbn.apply(variables, xs, mutable=["batch_stats"])
        y, upd = jbn.apply({**variables, **upd}, xs, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    mesh = jax_mesh()
    xs = pmesh.shard_batch(mesh, np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    jy, stats = two_steps(pmesh.replicate_tree(mesh, variables), xs)
    np.testing.assert_allclose(np.concatenate([o["y"] for o in out]),
                               np.asarray(jy).transpose(0, 3, 1, 2), **tol)
    for o in out:
        np.testing.assert_allclose(o["running_mean"], np.asarray(stats["mean"]), **tol)
        np.testing.assert_allclose(o["running_var"], np.asarray(stats["var"]), **tol)


@pytest.mark.parametrize("rank1_boxes", [0, 2], ids=["all_on_rank0", "six_and_two"])
def test_yolov5_loss_with_uneven_positives(ranks, rank1_boxes):
    """Six boxes in rank 0's images and ``rank1_boxes`` in rank 1's: the
    ranks' losses (and each term) sum to the one-process loss within 1e-5
    and their raw-map gradients are its gradient; the per-rank-normalised
    losses would sum to another value with every box on rank 0 (more than
    1 % off; measured 7.9 %), so the case can tell.  With boxes on both
    ranks a per-rank n_pos shows in the sum."""
    raws, tgt = loss_inputs(seed=2, B=4)
    tgt["valid"][2, :rank1_boxes] = True
    assert tgt["valid"][:2].sum() == 6 and tgt["valid"][2:].sum() == rank1_boxes
    out = ranks.run("job_yolov5_loss", raws, tgt, 3, DEFAULT_ANCHORS, timeout=30)

    loss = YOLOv5Loss(num_classes=3, anchors=DEFAULT_ANCHORS)
    raw = [torch.from_numpy(r).requires_grad_(True) for r in raws]
    total, parts = loss(raw, {k: torch.from_numpy(v) for k, v in tgt.items()})
    total.backward()
    total = total.detach()
    np.testing.assert_allclose(sum(o["total"] for o in out), float(total), rtol=1e-5)
    for k, v in parts.items():
        np.testing.assert_allclose(sum(o[k] for o in out), float(v.detach()), rtol=1e-5,
                                   atol=1e-7)
    for lvl, r in enumerate(raw):
        got = np.concatenate([o["grads"][lvl] for o in out])
        np.testing.assert_allclose(got, r.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(r.grad.abs().max()))
    if not rank1_boxes:
        local = sum(o["local_total"] for o in out)
        assert abs(local - float(total)) > 0.01 * abs(float(total)), (local, float(total))


def assert_grads_close(got: dict, want: dict, bound: float, what: str):
    """max |Δg| over max(leaf max |g|, 1e-3 · global max |g|) ≤ ``bound``
    for every leaf (the form of the JAX package's grad differential)."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(got[name] - w).max()) / scale
        assert err <= bound, f"{what}: {name} {err:.2e}"


def test_yolov5_train_step_matches_jax_data_mesh(ranks):
    """One float32 step of YOLOv5-n at 64², B = 4 (2 a rank), the flagship's
    optimizer recipe and EMA from a JAX state at step 3000, against JAX's
    ``make_train_step`` on a data=2 mesh with ``shard_batch``: the loss
    and its terms within 1e-5 relative; the parameters, BN statistics and
    EMA within 1e-5 absolute + 1e-4 relative (the single-device step's
    bound, ``test_torch_train_step``); the SGD momentum, which after one
    step is the step's gradient, by the gradient bound of
    ``assert_grads_close``: 5e-3 against JAX (one process of the port is
    1.5e-4 off JAX's float32 gradient already) and 1e-3 against one
    process of the port (measured 1.8e-4), with the recipe's norm clip
    and without it (the clip hides a gradient's scale).  Every rank holds
    the same state."""
    jm, variables, tm = make_pair("yolov5_n", seed=3)
    ema_vars = jax_variables(jm, seed=4)
    x = images(3, B=4)
    tgt = pixel_targets(seed=5, B=4)
    weights = (ranks_mod.state_arrays(tm),
               ranks_mod.state_arrays(make_pair("yolov5_n", seed=4)[2]))  # model, EMA
    out = ranks.run("job_yolov5_step", *weights, RECIPE, START, EMA_DECAY, x, tgt, timeout=60)

    jcfg = JaxConfig(RECIPE)
    tx = jax_build_optimizer(jcfg, jax_build_lr(jcfg, 10))
    mesh = jax_mesh()
    jstate = pmesh.replicate_tree(mesh, JaxTrainState(
        step=jnp.asarray(START, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        ema_params=ema_vars["params"], ema_batch_stats=ema_vars["batch_stats"],
        rng=jax.random.PRNGKey(0), apply_fn=jm.apply, tx=tx))
    jstep = jax_make_train_step(amp=False, ema_decay=EMA_DECAY, donate=False)
    jstate, jmetrics = jstep(jstate, pmesh.shard_batch(mesh, {"image": x, "target": tgt}))

    for o in out:
        assert o["step"] == int(jstate.step) == START + 1
        for k in ("loss", "box_loss", "obj_loss", "cls_loss"):
            np.testing.assert_allclose(o["metrics"][k], float(jmetrics[k]), rtol=1e-5)
    for name, tree, key in (("model", {"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}, "model"),
                            ("ema", {"params": jstate.ema_params,
                                     "batch_stats": jstate.ema_batch_stats}, "ema")):
        module = ranks_mod._yolov5(out[0][key])
        assert_tree_close(jax.device_get(tree), module, atol=1e-5, rtol=1e-4, what=name)
    trace = jax.device_get(jstate.opt_state[2][0].trace)
    state = tm.state_dict()
    jax_momentum = {}
    for path, arr in _flatten(trace):
        name = ".".join(path[:-1] + ({"kernel": "weight", "scale": "weight",
                                      "bias": "bias"}[path[-1]],))
        jax_momentum[name] = _convert(name, arr, state[name])
    assert_grads_close(out[0]["momentum"], jax_momentum, 5e-3, "momentum vs JAX")
    one = ranks_mod.job_yolov5_step(*weights, RECIPE, START, EMA_DECAY, x, tgt)
    assert_grads_close(out[0]["momentum"], one["momentum"], 1e-3, "momentum vs one process")
    # the norm clip (10) is active here and hides the gradient's scale:
    # without it the summed gradient must be the one process's too
    bare = {k: v for k, v in RECIPE.items() if k != "GRAD_CLIP"}
    args = (*weights, bare, START, EMA_DECAY, x, tgt)
    unclipped = ranks.run("job_yolov5_step", *args, timeout=60)
    assert_grads_close(unclipped[0]["momentum"], ranks_mod.job_yolov5_step(*args)["momentum"],
                       1e-3, "unclipped momentum vs one process")
    for key in ("model", "ema", "momentum"):
        for name, v in out[0][key].items():
            np.testing.assert_array_equal(out[1][key][name], v, err_msg=f"{key} {name}")


@pytest.mark.parametrize("name, kwargs", [
    ("CrossEntropyLoss2d", {"class_weights": [1.0, 2.0, 0.5]}),
    ("BCEWithLogitsLoss2d", {}),
    ("FocalLoss2d", {"class_weights": [1.0, 2.0, 0.5]}),
    ("DiceLoss", {}),
    ("CrossEntropyDiceLoss", {})])
def test_seg_loss_shares_sum_to_one_process(ranks, name, kwargs):
    """Each plain seg loss with ignored pixels, every one in rank 1's rows:
    the ranks' losses sum to the one-process loss of the global batch and
    their logit gradients are its gradient (1e-6 relative)."""
    from cvpytorch_tpu_torch.models.losses.seg_loss import SEG_LOSSES

    rng = np.random.RandomState(4)
    C = 1 if name == "BCEWithLogitsLoss2d" else 3
    logits = rng.randn(4, C, 6, 6).astype(np.float32)
    labels = rng.randint(0, 3 if C > 1 else 2, (4, 6, 6)).astype(np.int64)
    labels[2] = 255
    labels[3, :4] = 255
    out = ranks.run("job_seg_loss_share", name, logits, labels, kwargs, timeout=30)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = SEG_LOSSES[name](x, torch.from_numpy(labels), **kwargs)
    loss.backward()
    np.testing.assert_allclose(sum(o["loss"] for o in out), float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([o["grad"] for o in out]), x.grad.numpy(),
                               rtol=1e-6, atol=1e-6 * float(x.grad.abs().max()))


def test_kernel_build_log_lands_whole(tmp_path):
    """The NMS kernel's build log is renamed into place: ranks that build
    at once never read it half written, and no temporary file stays."""
    from cvpytorch_tpu_torch.ops import nms_kernel

    path = tmp_path / "nms_kernel_x.ptxas.txt"
    path.write_text("old")
    nms_kernel._write_atomic(path, "ptxas info: 32 registers\n" * 1000)
    assert path.read_text() == "ptxas info: 32 registers\n" * 1000
    assert [p.name for p in tmp_path.iterdir()] == [path.name]


UNET_RECIPE = {"INIT_LR": 0.01, "N_MAX_EPOCHS": 4,
               "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.9,
                             "WEIGHT_PARAMS": {"weight_decay": 1e-4}},
               "LR_SCHEDULER": {"TYPE": "PolyLR"}}


@pytest.mark.parametrize("extra", [None, "DiceLoss"], ids=["ce", "ce_dice"])
def test_unet_step_matches_one_process(ranks, extra):
    """A narrow UNet (base 4, depth 2) at 32², B = 4, class-weighted CE with
    ignored pixels (and the Dice extra loss): one step at W = 2 against one
    process, loss within 1e-5 relative, parameters and BN statistics
    within 1e-6 absolute + 1e-5 relative."""
    rng = np.random.RandomState(7)
    image = rng.rand(4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 4, (4, 32, 32)).astype(np.int64)
    labels[0, :10] = 255
    labels[3] = 255
    torch.manual_seed(0)
    model = ranks_mod.unet(extra)
    weights = ranks_mod.state_arrays(model)
    out = ranks.run("job_unet_step", weights, image, labels, UNET_RECIPE, extra, timeout=30)

    cfg = CommonConfiguration(UNET_RECIPE)
    state = create_train_state(model, build_optimizer(cfg, model, build_lr_scheduler(cfg, 4)))
    state, metrics = make_train_step()(state, {"image": torch.from_numpy(image),
                                               "target": torch.from_numpy(labels)})
    for o in out:
        for k, v in metrics.items():
            np.testing.assert_allclose(o["metrics"][k], float(v), rtol=1e-5)
        for name, v in ranks_mod.state_arrays(model).items():
            np.testing.assert_allclose(o["model"][name], v, atol=1e-6, rtol=1e-5, err_msg=name)


# -- the evaluators' merges ----------------------------------------------------

def _det_batches(n_batches=3, B=4, M=3, K=5, C=2, seed=0):
    """Detection batches (targets, preds, positions) where images of
    different batches, and of both ranks' rows, share detection scores."""
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n_batches):
        gt = rng.uniform(0, 40, (B, M, 2))
        boxes = np.concatenate([gt, gt + rng.uniform(8, 20, (B, M, 2))], -1)
        det = boxes[:, rng.randint(0, M, K)] + rng.randn(B, K, 4) * np.where(
            rng.rand(B, K, 1) < 0.5, 0.5, 8.0)
        scores = rng.choice([0.9, 0.7, 0.5], (B, K))  # ties across images
        targets = {"boxes": boxes.astype(np.float32), "labels": rng.randint(0, C, (B, M)),
                   "valid": rng.rand(B, M) < 0.9}
        preds = {"boxes": det.astype(np.float32), "scores": scores.astype(np.float32),
                 "labels": rng.randint(0, C, (B, K)), "valid": rng.rand(B, K) < 0.9}
        out.append((targets, preds, np.arange(b * B, (b + 1) * B)))
    return out


def _one_process(name, kwargs, batches):
    ev = EVALUATORS.get(name)(**kwargs)
    for targets, preds, _ in batches:
        ev.update(targets, preds)
    return ev.evaluate()


def _rank_by_rank_concat(name, kwargs, batches):
    """What a merge that concatenates the ranks' records sees: rank 0's rows
    of every batch, then rank 1's."""
    order = [(b, np.array_split(np.arange(len(p)), W)[r])
             for r in range(W) for b, (_, _, p) in enumerate(batches)]
    ev = EVALUATORS.get(name)(**kwargs)
    take = lambda tree, i: {k: np.asarray(v)[i] for k, v in tree.items()}
    for b, rows in order:
        ev.update(take(batches[b][0], rows), take(batches[b][1], rows))
    return ev.evaluate()


@pytest.mark.parametrize("name", ["coco_detection", "voc_detection"])
def test_det_merges_restore_single_process_order(ranks, name):
    """With cross-image score ties the merged W = 2 metrics equal one
    process's exactly; a rank-by-rank concatenation of the same records
    gives others (so the case tells).  COCO also equals JAX's
    ``merge_state_dicts`` fed the one-process order's halves."""
    kwargs = {"num_classes": 2}
    batches = _det_batches(seed=3 if name == "coco_detection" else 1)
    (merged0, merged1) = ranks.run("job_evaluator_merge", name, kwargs, batches, timeout=30)
    want = _one_process(name, kwargs, batches)
    assert merged0 == merged1 == want
    assert _rank_by_rank_concat(name, kwargs, batches) != want
    if name == "coco_detection":
        halves = []
        for part in (batches[:2], batches[2:]):
            ev = JaxCocoEvaluator(num_classes=2)
            for t, p, _ in part:
                ev.update(t, p)
            halves.append(ev.state_dict())
        jev = JaxCocoEvaluator(num_classes=2)
        jev.merge_state_dicts(halves)
        jax_metrics = jev.evaluate()
        for k, v in want.items():
            assert v == pytest.approx(jax_metrics[k], abs=1e-12), k


def _seg_batches(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 3, (3, 6, 6)).astype(np.int64),
             rng.randint(0, 3, (3, 6, 6)).astype(np.uint8), np.arange(b * 3, b * 3 + 3))
            for b in range(3)]


def _cls_batches(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 4, 5), rng.randint(0, 4, 5).astype(np.uint8),
             np.arange(b * 5, b * 5 + 5)) for b in range(3)]


def _kpt_batches(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for b in range(3):
        gt = rng.uniform(0, 50, (4, 17, 2))
        t = {"keypoints": gt, "valid": rng.rand(4, 17) < 0.8,
             "bbox_size": rng.uniform(20, 60, 4)}
        p = np.concatenate([gt + rng.randn(4, 17, 2) * 5, rng.rand(4, 17, 1)], -1)
        out.append((t, p, np.arange(b * 4, b * 4 + 4)))
    return out


@pytest.mark.parametrize("name, kwargs, make", [
    ("segmentation", {"num_classes": 3}, _seg_batches),
    ("classification", {"num_classes": 4}, _cls_batches),
    ("keypoint", {}, _kpt_batches)])
def test_other_merges_equal_one_process(ranks, name, kwargs, make):
    """The seg confusion matrix, the cls counts and the keypoint PCK/OKS
    lists merge to one process's metrics at W = 2 (their sums and
    threshold counts do not depend on the order)."""
    batches = make()
    (merged0, merged1) = ranks.run("job_evaluator_merge", name, kwargs, batches, timeout=30)
    want = _one_process(name, kwargs, batches)
    np.testing.assert_equal(merged0, want)
    np.testing.assert_equal(merged1, want)


# -- the trainer ---------------------------------------------------------------

RUN_VAL_IMAGES = 6


def trainer_run_setting(tmp_path, lr: float) -> str:
    """The config of ``test_trainer_run_two_ranks_equals_one`` at ``lr``
    (also run by ``tests/torch_dp_lr_witness.py``)."""
    train = {**DEVICE_AUG["train"], "LENGTH": 16}
    val = {**VAL_64, "LENGTH": RUN_VAL_IMAGES, "BATCH_SIZE": 4}
    return write_config(tmp_path, train, val, N_MAX_EPOCHS=2, EMA=True, INIT_LR=lr,
                        EVALUATOR={"NAME": "coco_detection", "EVAL_TYPE": "mAP",
                                   "EVAL_INTERVALS": 1})


def test_trainer_run_two_ranks_equals_one(ranks, tmp_path):
    """``Trainer.run()`` of YOLOv5-n at 64² with ``DEVICE_AUG`` (each
    sample's ``LOAD_NUM`` group fixed, ``torch_dp_ranks.fixed_groups``:
    the host draws are each rank's own), EMA, two
    epochs of two steps at a global batch of 8 and a val of 6 images in
    batches of 4 (rank 0 scores images 0, 1 and 4, rank 1 images 2, 3 and
    5), through W = 2 ranks and through one process: the logged losses
    within 1e-5 relative, the parameters and EMA within 1e-5 absolute +
    1e-4 relative and the four updates' sum (parameters after the run less
    before) by ``assert_grads_close`` within 1e-2, the val metrics within
    1e-6; only rank 0 wrote a
    checkpoint directory, which holds no ``module.`` key and serves
    through ``infer.main``.  INIT_LR is 1e-5 because at the tests' 0.01
    this random-weight run amplifies float32 rounding, as
    ``python -m tests.torch_dp_lr_witness`` shows: at 0.01 the two ranks'
    step losses sit 7.9e-7, 1.4e-4, 7.6e-3 and 2.0e-2 from one process's,
    and one process on four threads instead of one (another reduction
    order, nothing else) 8.6e-7, 7.5e-5, 3.0e-3 and 2.3e-4; the four
    updates' sum differs by 0.26 and 0.10 of a leaf.  Trained in float64,
    the two ranks stay within 2.9e-12 of one process's parameters and
    6.9e-10 of its updates: rounding amplified, not a departure of the
    two ranks.  At 1e-5 step 2's losses are 7e-8 apart."""
    setting = trainer_run_setting(tmp_path, 1e-5)
    body = json.loads(open(setting).read())
    body["CHECKPOINT_DIR"] = str(tmp_path / "ckpts_one_process")
    (tmp_path / "one.json").write_text(json.dumps(body))
    two = ranks.run("job_trainer_run", setting, timeout=90)
    one = ranks_mod.job_trainer_run(str(tmp_path / "one.json"))
    assert one["world"] == 1 and [o["world"] for o in two] == [2, 2]
    assert len(one["logged"]) == 4 and one["iters"] == two[0]["iters"] == 2
    for o in two:
        for got, want in zip(o["logged"], one["logged"], strict=True):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        for key in ("model", "ema"):
            for name, v in one[key].items():
                np.testing.assert_allclose(o[key][name], v, atol=1e-5, rtol=1e-4,
                                           err_msg=f"{key} {name}")
        moved = lambda run: {k: run["model"][k] - v for k, v in run["initial"].items()
                             if v.dtype.kind == "f"}
        assert_grads_close(moved(o), moved(one), 1e-2, "the four updates")
        assert len(o["val"]) == len(one["val"]) == 2
        for got, want in zip(o["val"], one["val"]):
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)
    assert two[1]["save_dir"] is None
    assert os.listdir(tmp_path / "ckpts") == [os.path.basename(two[0]["save_dir"])]
    ckpt = Checkpoints.load(os.path.join(two[0]["save_dir"], "last.pt"))
    assert not any(k.startswith("module.") for k in ckpt["model"])
    infer.main(["--setting", setting, "--checkpoint",
                os.path.join(two[0]["save_dir"], "last.pt"),
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    served = json.loads((tmp_path / "served" / "predictions.json").read_text())
    assert len(served) == RUN_VAL_IMAGES


def test_refusals_under_two_ranks(ranks, tmp_path):
    """Under W = 2: ``PARALLEL`` with ``SPATIAL: 2``, a model whose loss is not
    global yet (ObjectBox, a YOLOv5 subclass with its own loss),
    ``AMP_BN_BF16_STATS``, a BN in ``bf16_stats``, OHEM and Lovász each
    raise ``NotImplementedError`` naming their ROADMAP item."""
    base = dict(train=dict(VAL_64), val=dict(VAL_64))
    for sub in "pob":
        (tmp_path / sub).mkdir()
    cases = {
        "parallel": (write_config(tmp_path / "p", **base, PARALLEL={"SPATIAL": 2}), "11b"),
        "objectbox": (write_config(tmp_path / "o", **base), "11c"),
        "bf16": (write_config(tmp_path / "b", **base, AMP=True, AMP_BN_BF16_STATS=True),
                 "11c"),
    }
    obj = json.loads(open(cases["objectbox"][0]).read())
    obj["USE_MODEL"] = {"CLASS": "ObjectBox", "TYPE": "objectbox_n"}
    open(cases["objectbox"][0], "w").write(json.dumps(obj))
    for key, (setting, item) in cases.items():
        for msg in ranks.run("job_trainer_refusal", setting, timeout=30):
            assert msg and f"ROADMAP, Queue 1 item {item}" in msg, (key, msg)
    for msg in ranks.run("job_bn_refuses_bf16_stats", timeout=30):
        assert msg and "item 11c" in msg
    for loss in ("OhemCrossEntropyLoss2d", "LovaszSoftmax"):
        for msg in ranks.run("job_seg_loss_refusal", loss, timeout=30):
            assert msg and "item 11c" in msg, (loss, msg)
