"""The port's train step, EMA and checkpoints.

One float32 train step with EMA against the JAX ``make_train_step`` from
the same state and batch (YOLOv5-n, 64², B=2, the flagship's optimizer
recipe), the EMA blend alone, the checkpoint round trip (resume is
bit-exact) and ``EarlyStopping``'s decisions against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.optim.optimizers import build_optimizer as jax_build_optimizer
from cvpytorch_tpu.optim.schedules import build_lr_scheduler as jax_build_lr
from cvpytorch_tpu.train_state import TrainState as JaxTrainState
from cvpytorch_tpu.train_state import make_train_step as jax_make_train_step
from cvpytorch_tpu.utils.checkpoints import EarlyStopping as JaxEarlyStopping
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
from cvpytorch_tpu_torch.train_state import (
    TrainState, create_train_state, ema_blend, make_train_step)
from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints, EarlyStopping
from cvpytorch_tpu_torch.utils.porting import _convert, _flatten, load_jax_variables
from tests.test_torch_train_loss import one_torch_thread, pixel_targets  # noqa: F401  (autouse)
from tests.test_torch_yolov5 import DICTIONARY, images, jax_variables, make_pair

RECIPE = {  # conf/coco_yolov5_s.yml's optimizer, schedule and clip
    "INIT_LR": 0.01, "N_MAX_EPOCHS": 300,
    "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.937,
                  "WEIGHT_PARAMS": {"weight_decay": 0.0005}},
    "LR_SCHEDULER": {"TYPE": "LambdaLR", "LRF": 0.1},
    "WARMUP": {"NAME": "linear", "ITERS": 1000, "FACTOR": 0.1},
    "GRAD_CLIP": {"TYPE": "norm", "VALUE": 10.0},
}
EMA_DECAY = 0.9999
START = 3000  # the EMA decay at step START + 1 is 0.7768


@pytest.fixture(autouse=True)
def jax_default_path(monkeypatch):
    monkeypatch.delenv("CVT_OBJ_SLICE", raising=False)
    monkeypatch.delenv("CVT_BN_BF16_STATS", raising=False)


def _port_name(coll, path):
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}[path[-1]]
    return ".".join(path[:-1] + (leaf,))


def assert_tree_close(tree, module, atol, rtol, what):
    state = module.state_dict()
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(tree[coll]):
            name = _port_name(coll, path)
            want = _convert(name, arr, state[name])
            got = state[name].numpy()
            np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                       err_msg=f"{what} {name}")


def test_train_step_with_ema_matches_jax():
    """Losses within 1e-5 relative; after the update, parameters and BN
    running statistics within 1e-5 absolute + 1e-4 relative, and so the
    EMA (a blend of two states with decay 0.7768).  Measured max |diff|:
    1.1e-5 in the model (a BN running variance, 1.4e-5 relative: the two
    frameworks' batch variances sum in other orders), 2.4e-6 in the EMA."""
    jm, variables, tm = make_pair("yolov5_n", seed=3)
    ema_vars = jax_variables(jm, seed=4)
    x = images(3)
    tgt = pixel_targets(seed=5)

    jcfg = JaxConfig(RECIPE)
    tx = jax_build_optimizer(jcfg, jax_build_lr(jcfg, 10))
    jstate = JaxTrainState(
        step=jnp.asarray(START, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        ema_params=ema_vars["params"], ema_batch_stats=ema_vars["batch_stats"],
        rng=jax.random.PRNGKey(0), apply_fn=jm.apply, tx=tx)
    jstep = jax_make_train_step(amp=False, ema_decay=EMA_DECAY, donate=False)
    jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x),
                                      "target": {k: jnp.asarray(v) for k, v in tgt.items()}})

    cfg = CommonConfiguration(RECIPE)
    ema = load_jax_variables(YOLOv5(dictionary=DICTIONARY, model_cfg={"TYPE": "yolov5_n"}),
                             ema_vars)
    state = TrainState(model=tm, optimizer=build_optimizer(cfg, tm, build_lr_scheduler(cfg, 10)),
                       ema=ema.eval(), step=START)
    state, metrics = make_train_step(amp=False, ema_decay=EMA_DECAY)(
        state, {"image": torch.from_numpy(x),
                "target": {k: torch.from_numpy(v) for k, v in tgt.items()}})

    assert state.step == int(jstate.step) == START + 1
    for k in ("loss", "box_loss", "obj_loss", "cls_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    assert_tree_close({"params": jstate.params, "batch_stats": jstate.batch_stats},
                      state.model, atol=1e-5, rtol=1e-4, what="model")
    assert_tree_close({"params": jstate.ema_params, "batch_stats": jstate.ema_batch_stats},
                      state.ema, atol=1e-5, rtol=1e-4, what="ema")


def test_ema_blend_matches_jax():
    """d·e + (1 − d)·p on identical inputs and the same float32 d: within
    1e-7 relative (measured: bit-equal)."""
    rng = np.random.RandomState(9)
    e = rng.randn(1000).astype(np.float32)
    p = rng.randn(1000).astype(np.float32)
    d = np.float32(0.9999) * (np.float32(1) - np.exp(-np.float32(17) / np.float32(2000)))
    want = np.asarray(jnp.float32(d) * jnp.asarray(e) + (1.0 - jnp.float32(d)) * jnp.asarray(p))
    got = torch.from_numpy(e.copy())
    ema_blend([got], [torch.from_numpy(p)], float(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def _small_state(seed):
    torch.manual_seed(seed)
    model = YOLOv5(dictionary=DICTIONARY, model_cfg={"TYPE": "yolov5_n"})
    body = {**RECIPE, "WARMUP": {"NAME": "linear", "ITERS": 2, "FACTOR": 0.1}}
    cfg = CommonConfiguration(body)
    opt = build_optimizer(cfg, model, build_lr_scheduler(cfg, 2))
    return create_train_state(model, opt, use_ema=True)


def _batches():
    x = (np.random.RandomState(11).rand(3, 2, 32, 32, 3) * 255).astype(np.uint8)
    t = pixel_targets(seed=6)
    t["boxes"] = t["boxes"] / 2
    return [{"image": torch.from_numpy(x[i]),
             "target": {k: torch.from_numpy(v) for k, v in t.items()}} for i in range(3)]


def test_checkpoint_round_trip_resumes_bit_exact(tmp_path):
    """Two steps, save, restore into a fresh state, one step: equal bit for
    bit to three steps straight (model, BN statistics, EMA, optimizer)."""
    step = make_train_step(amp=False, ema_decay=EMA_DECAY)
    batches = _batches()
    straight = _small_state(0)
    for b in batches:
        step(straight, b)

    first = _small_state(0)
    for b in batches[:2]:
        step(first, b)
    ckpts = Checkpoints(str(tmp_path), "rt", "YOLOv5", async_save=True)
    ckpts.save_checkpoint(first, "last", extra={"epoch": 0})
    ckpts.wait()
    resumed = Checkpoints.restore_into(_small_state(1), f"{ckpts.save_dir}/last.pt")
    assert resumed.step == 2 and resumed.optimizer.count == 2
    step(resumed, batches[2])

    assert resumed.step == straight.step == 3
    for a, b in ((resumed.model, straight.model), (resumed.ema, straight.ema)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    sa, sb = resumed.optimizer.state_dict(), straight.optimizer.state_dict()
    assert sa["chain"]["count"] == sb["chain"]["count"] == 3
    for k in sb["state"]:
        assert torch.equal(sa["state"][k]["momentum_buffer"],
                           sb["state"][k]["momentum_buffer"])


def test_autosave_and_load_weights_take_ema(tmp_path):
    """``best``/``deploy`` on improvement only; ``deploy`` is the EMA's bare
    state_dict; ``load_weights_into`` takes a trainer checkpoint's EMA."""
    state = _small_state(0)
    step = make_train_step(amp=False, ema_decay=EMA_DECAY)
    step(state, _batches()[0])
    ckpts = Checkpoints(str(tmp_path), "auto", "YOLOv5", async_save=False)
    ckpts.autosave_checkpoint(state, epoch=0, is_best=False)
    assert sorted(p.name for p in tmp_path.glob("*/*.pt")) == ["last.pt"]
    ckpts.autosave_checkpoint(state, epoch=1, is_best=True)
    assert sorted(p.name for p in tmp_path.glob("*/*.pt")) == ["best.pt", "deploy.pt", "last.pt"]
    assert Checkpoints.load(f"{ckpts.save_dir}/last.pt")["extra"]["epoch"] == 1
    for name in ("deploy.pt", "best.pt"):
        fresh = YOLOv5(dictionary=DICTIONARY, model_cfg={"TYPE": "yolov5_n"})
        Checkpoints.load_weights_into(fresh, f"{ckpts.save_dir}/{name}")
        for (k, v), w in zip(fresh.state_dict().items(), state.ema.state_dict().values()):
            assert torch.equal(v, w), (name, k)


def test_early_stopping_decides_as_jax():
    perfs = [0.1, 0.3, 0.2, 0.3, 0.25, 0.1, 0.05, 0.4, 0.3, 0.2, 0.1]
    for patience in (0, 1, 2, 3):
        j, t = JaxEarlyStopping(patience), EarlyStopping(patience)
        assert [t(e, p) for e, p in enumerate(perfs)] == \
            [j(e, p) for e, p in enumerate(perfs)]
        assert (t.best_epoch, t.best_perf) == (j.best_epoch, j.best_perf)
