"""The port's mesh, tensor parallelism and overlap-tile ``spatial_apply`` on
four gloo ranks on the CPU.

Four ranks spawned once for the file (``tests/torch_dp_ranks.py``: they
import the port only), each call with its own timeout:

* the port's ``tp_shardings`` against JAX's on its test tree and on
  YOLOv5-n's whole variable tree, through the weight carry's key map;
* data = 2 × model = 2: two steps of YOLOv5-n on JAX's TP test recipe and
  batch against the port's one process;
* data = 1 × model = 4: MobileNetV2 classification, which data
  parallelism still refuses, against one process;
* ``Trainer.run()`` with ``PARALLEL: {MODEL: 2}`` at data = 2 against one
  process, its checkpoint against one process's, and a one-process
  checkpoint resumed under tensor parallelism;
* the refusals;
* ``spatial_apply`` against JAX's on four devices, on JAX's two test
  models, over the whole output.

JAX's own dp×tp step is not run here: ``tests/test_parallel_tp.py`` holds
it against one device, and the port's one-process YOLOv5 step is held
against JAX by ``tests/test_torch_train_step.py`` and
``tests/test_torch_parallel_dp.py``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from cvpytorch_tpu.parallel import mesh as jax_mesh
from cvpytorch_tpu.parallel.spatial import spatial_apply as jax_spatial_apply
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models.classification import Classification
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
from cvpytorch_tpu_torch.parallel.mesh import Mesh, shard_train_state, tp_shardings
from cvpytorch_tpu_torch.parallel.tensor import own_block
from cvpytorch_tpu_torch.train_state import TrainState
from cvpytorch_tpu_torch.trainer import Trainer, check_parallel
from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints
from cvpytorch_tpu_torch.utils.porting import _flatten, load_jax_variables, port_name
from tests import torch_dp_ranks as ranks_mod
from tests.test_parallel_spatial import SmallFCN
from tests.test_parallel_tp import _batch as jax_tp_batch
from tests.test_torch_parallel_dp import assert_grads_close, trainer_run_setting
from tests.test_torch_train_step import RECIPE
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolov5 import jax_variables

W = 4
JAX_TP_RECIPE = {  # tests/test_parallel_tp.py's
    "INIT_LR": 0.01, "N_MAX_EPOCHS": 1,
    "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.9},
    "LR_SCHEDULER": {"TYPE": "CosineAnnealingLR"},
}
YOLO_CLASSES = tuple({f"c{i}": 1.0} for i in range(4))


@pytest.fixture(scope="module")
def ranks():
    pool = ranks_mod.RankPool(W)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def yolo():
    """YOLOv5-n of JAX's TP test (4 classes): the JAX variables and the
    port's model carried from them."""
    jm = JaxYOLOv5(dictionary=YOLO_CLASSES, model_cfg={"TYPE": "yolov5_n"})
    variables = jax_variables(jm, seed=3)
    tm = load_jax_variables(YOLOv5(dictionary=YOLO_CLASSES, model_cfg={"TYPE": "yolov5_n"}),
                            variables)
    return variables, tm


def jax_sharded(tree, model: int) -> set:
    """The leaves JAX's ``tp_shardings`` shards on a data=4/model mesh."""
    specs = jax_mesh.tp_shardings(tree, jax_mesh.create_mesh(
        data=8 // model, model=model, devices=jax.devices()[:8]))
    return {path for path, s in _flatten(jax.tree_util.tree_map(
        lambda s: s.spec != jax.sharding.PartitionSpec(), specs)) if s}


def port_sharded(model: torch.nn.Module, n: int) -> dict:
    return {k: v for k, v in tp_shardings(model, Mesh(model=n)).items() if v}


def test_rule_picks_jax_leaves(yolo):
    """(a) The port's rule on ``test_parallel_tp.py``'s tree, as port
    modules (a 3×3 conv 32 → 64 with a bias, a 256 → 128 dense, a (4, 6)
    and an (8, 8, 9) leaf) and on YOLOv5-n's whole tree, against JAX's
    ``tp_shardings`` at model = 2: the same leaves, through the weight
    carry's key map, and more than 10 of YOLOv5-n's; the Flax trailing
    dim is torch's dim 0 of a conv and a dense weight."""
    class Tree(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(32, 64, 3)
            self.dense = torch.nn.Linear(256, 128, bias=False)
            self.tiny = torch.nn.Parameter(torch.zeros(4, 6))
            self.odd = torch.nn.Parameter(torch.zeros(8, 8, 9))

    tree = {"conv": {"kernel": jnp.zeros((3, 3, 32, 64)), "bias": jnp.zeros((64,))},
            "dense": {"kernel": jnp.zeros((256, 128))},
            "tiny": jnp.zeros((4, 6)), "odd": jnp.zeros((8, 8, 9))}
    port = port_sharded(Tree(), 2)
    assert {port_name("params", p, {"tiny", "odd"}) for p in jax_sharded(tree, 2)} == set(port)
    assert port == {"conv.weight": (0, 1), "dense.weight": (0, 1)}

    variables, tm = yolo
    want = {port_name(coll, path[1:], dict(tm.named_parameters()))
            for coll, sub in variables.items()
            for path in {(coll,) + p for p in jax_sharded(sub, 2)}}
    got = port_sharded(tm, 2)
    assert want == set(got) and len(got) > 10
    assert all(v == (0, 1) for v in got.values())


def test_jax_tree_loads_into_a_sharded_model(yolo):
    """``load_jax_variables`` into YOLOv5-n laid out for model = 2 (as rank
    1 holds it; laying out needs no collective): every leaf the rule
    shards takes its block of the carried leaf, bit for bit, and every
    other leaf the whole of it."""
    variables, tm = yolo
    full = ranks_mod.state_arrays(tm)
    model = YOLOv5(dictionary=YOLO_CLASSES, model_cfg={"TYPE": "yolov5_n"})
    cfg = CommonConfiguration(JAX_TP_RECIPE)
    shard_train_state(TrainState(model=model, optimizer=build_optimizer(
        cfg, model, build_lr_scheduler(cfg, 10))), Mesh(data=1, model=2, rank=1))
    load_jax_variables(model, variables)
    plan = port_sharded(tm, 2)
    assert len(plan) > 10
    for name, v in model.state_dict().items():
        want = torch.from_numpy(full[name])
        if name in plan:
            want = own_block(want, *plan[name], 2, 1)
        np.testing.assert_array_equal(v.numpy(), want.numpy(), err_msg=name)


def assert_holds_blocks(out: list, plan: dict, full: dict, shapes: dict):
    """Each rank holds, of every leaf ``plan`` shards, exactly its block
    of the gathered leaf and nothing more; every other leaf in full."""
    for o in out:
        h = o["held"]
        assert set(h["blocks"]) == set(plan)
        for name, shape in shapes.items():
            if name not in plan:
                assert h["shapes"][name] == shape, name
                continue
            block, dim, outer, parts, index = h["blocks"][name]
            assert (dim, outer) == plan[name]
            want = own_block(torch.from_numpy(full[name]), dim, outer, parts, index)
            assert h["shapes"][name] == tuple(want.shape) != shape, name
            np.testing.assert_array_equal(block, want.numpy(), err_msg=name)


def test_dp_tp_yolov5_steps_match_one_process(ranks, yolo):
    """(b) data = 2 × model = 2, YOLOv5-n at 64², B = 8, two steps of
    JAX's TP test recipe on its batch: in float32 each step's loss within
    JAX's rtol 2e-4 of the port's one process; in float64 the parameters,
    BN statistics and SGD moments within 1e-10; each rank holding only its
    blocks of the leaves the rule shards."""
    _, tm = yolo
    weights = ranks_mod.state_arrays(tm)
    batch = jax_tp_batch()
    args = ("yolov5_n", weights, JAX_TP_RECIPE, batch["image"], batch["target"])
    for float64 in (False, True):
        out = ranks.run("job_tp_steps", *args, 2, 2, float64, timeout=90)
        one = ranks_mod.job_tp_steps(*args, 1, 2, float64)
        assert [o["mesh"] for o in out] == [{"data": 2, "model": 2, "spatial": 1}] * W
        for o in out:
            if not float64:
                np.testing.assert_allclose(o["losses"], one["losses"], rtol=2e-4)
                continue
            for name, v in one["model"].items():
                np.testing.assert_allclose(o["model"][name], v, rtol=0, atol=1e-10,
                                           err_msg=name)
            assert one["optimizer"].keys() == o["optimizer"].keys()
            for i, st in one["optimizer"].items():
                np.testing.assert_allclose(o["optimizer"][i]["momentum_buffer"],
                                           st["momentum_buffer"], rtol=0, atol=1e-10,
                                           err_msg=str(i))
    plan = port_sharded(tm, 2)
    assert_holds_blocks(out, plan, out[0]["model"],
                        {n: tuple(p.shape) for n, p in tm.named_parameters()})


def test_model_parallel_mobilenetv2_matches_one_process(ranks):
    """(c) data = 1 × model = 4: MobileNetV2 classification (width 1, 8
    classes, dropout 0.2 drawn alike) in channels_last, as the trainer
    lays a model out (the replicated 3×3 stem's gradient is then an NHWC
    tensor of equal C, H and W), at 32², B = 4, two float64 steps of
    the flagship optimizer recipe with its norm clip: the losses within
    1e-10 relative, the parameters, BN statistics and moments within 1e-10
    of one process; the depthwise 3×3 convolutions of 576 and 960 channels
    and the classifier's Linear are among the blocks."""
    torch.manual_seed(5)
    model = Classification(dictionary=tuple({f"c{i}": 1.0} for i in range(8)),
                           model_cfg={"BACKBONE": {"name": "MobileNetV2"}})
    weights = ranks_mod.state_arrays(model)
    rng = np.random.RandomState(6)
    image = rng.rand(4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 8, 4).astype(np.int64)
    args = ("mobilenet_v2", weights, RECIPE, image, labels)
    out = ranks.run("job_tp_steps", *args, 4, 2, True, True, timeout=90)
    one = ranks_mod.job_tp_steps(*args, 1, 2, True, True)
    plan = port_sharded(model, 4)
    assert "backbone.fc.weight" in plan
    depthwise = [n for n in plan
                 if getattr(model.get_submodule(n.rpartition(".")[0]), "groups", 1) > 1]
    assert len(depthwise) >= 4, depthwise
    for o in out:
        assert o["mesh"] == {"data": 1, "model": 4, "spatial": 1}
        np.testing.assert_allclose(o["losses"], one["losses"], rtol=1e-10)
        for name, v in one["model"].items():
            np.testing.assert_allclose(o["model"][name], v, rtol=0, atol=1e-10, err_msg=name)
        for i, st in one["optimizer"].items():
            np.testing.assert_allclose(o["optimizer"][i]["momentum_buffer"],
                                       st["momentum_buffer"], rtol=0, atol=1e-10,
                                       err_msg=str(i))
    assert_holds_blocks(out, plan, out[0]["model"],
                        {n: tuple(p.shape) for n, p in model.named_parameters()})


def _checkpoint_arrays(path) -> dict:
    ckpt = Checkpoints.load(path)
    as_np = lambda sd: {k: v.numpy() for k, v in sd.items()}
    return {"step": ckpt["step"], "model": as_np(ckpt["model"]), "ema": as_np(ckpt["ema"]),
            "momentum": {i: st["momentum_buffer"].numpy()
                         for i, st in ckpt["optimizer"]["state"].items()}}


def test_trainer_run_model_parallel_equals_one_process(ranks, tmp_path):
    """(d) ``Trainer.run()`` with ``PARALLEL: {MODEL: 2}`` on four ranks
    (data = 2 × model = 2) against one process: the run of
    ``test_torch_parallel_dp``'s trainer case (YOLOv5-n at 64², the device
    augmentation, EMA) cut to one epoch of two steps at a global batch of
    8 and a val of 6 images, at its INIT_LR of 1e-5, where its witness
    (``python -m tests.torch_dp_lr_witness``) shows two steps' rounding
    is not amplified.  Every rank's logged losses within 1e-5 relative of
    one process's; the val metrics within 1e-6; rank 0 alone wrote a
    checkpoint, which holds the whole model: its parameters, BN statistics
    and EMA within 1e-5 absolute + 1e-4 relative of one process's
    checkpoint, its SGD moments by ``assert_grads_close`` within 1e-2;
    every rank held only its blocks.  The checkpoint serves in one process
    (``infer.main``), and one process's checkpoint resumes under
    ``MODEL: 2``: the sharded state gathers back to it bit for bit."""
    setting = trainer_run_setting(tmp_path, 1e-5)
    body = {**json.loads(open(setting).read()), "N_MAX_EPOCHS": 1}
    one_body = {**body, "CHECKPOINT_DIR": str(tmp_path / "ckpts_one_process")}
    (tmp_path / "one.json").write_text(json.dumps(one_body))
    body["PARALLEL"] = {"MODEL": 2}
    (tmp_path / "tp.json").write_text(json.dumps(body))
    tp = ranks.run("job_trainer_run", str(tmp_path / "tp.json"), timeout=120)
    one = ranks_mod.job_trainer_run(str(tmp_path / "one.json"))
    assert len(one["logged"]) == 2 and [o["world"] for o in tp] == [W] * W
    for o in tp:
        for got, want in zip(o["logged"], one["logged"], strict=True):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        assert len(o["val"]) == 1
        for got, want in zip(o["val"], one["val"]):
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)
    assert [o["save_dir"] is not None for o in tp] == [True] + [False] * (W - 1)
    tp_last = os.path.join(tp[0]["save_dir"], "last.pt")
    one_last = os.path.join(one["save_dir"], "last.pt")
    got, want = _checkpoint_arrays(tp_last), _checkpoint_arrays(one_last)
    assert got["step"] == want["step"] == 2
    for key in ("model", "ema"):
        assert got[key].keys() == want[key].keys()
        for name, v in want[key].items():
            np.testing.assert_allclose(got[key][name], v, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{key} {name}")
    assert_grads_close(got["momentum"], want["momentum"], 1e-2, "SGD moments")
    model = YOLOv5(dictionary=({"thing": 1.0}, {"stuff": 1.0}), model_cfg={"TYPE": "yolov5_n"})
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert_holds_blocks(tp, port_sharded(model, 2), got["model"], shapes)

    infer.main(["--setting", str(tmp_path / "tp.json"), "--checkpoint", tp_last,
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    served = json.loads((tmp_path / "served" / "predictions.json").read_text())
    assert len(served) == 6

    body.update(PRETRAIN_MODEL=one_last, RESUME=True)
    (tmp_path / "resume.json").write_text(json.dumps(body))
    resumed = ranks.run("job_trainer_resume", str(tmp_path / "resume.json"), timeout=60)
    ckpt = Checkpoints.load(one_last)
    for o in resumed:
        assert o["step"] == 2 and o["start_epoch"] == 0
        for key in ("model", "ema"):
            for name, v in ckpt[key].items():
                np.testing.assert_array_equal(o[key][name], v.numpy(), err_msg=name)
        assert o["optimizer"].keys() == ckpt["optimizer"]["state"].keys()
        for i, st in ckpt["optimizer"]["state"].items():
            np.testing.assert_array_equal(o["optimizer"][i]["momentum_buffer"],
                                          st["momentum_buffer"].numpy())
    assert_holds_blocks(resumed, port_sharded(model, 2), want["model"], shapes)


def test_refusals(ranks, tmp_path):
    """(e) ``SPATIAL`` above 1 raises naming ROADMAP item 11b-2; a model
    axis that does not divide the four ranks raises; a grouped convolution
    whose column blocks do not align with its groups, and a leaf the rule
    shards that two modules share, raise at ``shard_train_state`` naming
    themselves, before anything is sharded."""
    with pytest.raises(NotImplementedError, match="ROADMAP, Queue 1 item 11b-2"):
        check_parallel({"MODEL": 2, "SPATIAL": 2})
    assert check_parallel({"MODEL": 2}) == (2, 1)
    for msg in ranks.run("job_mesh_refusal", 3, timeout=30):
        assert msg == "4 ranks not divisible by model=3*spatial=1"
    for msg in ranks.run("job_mesh_refusal", 2, 4, timeout=30):
        assert msg == "4 ranks not divisible by model=2*spatial=4"

    class Grouped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(48, 96, 3, groups=3)  # 32 outputs a group

    class Tied(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(64, 128)
            self.b = torch.nn.Linear(64, 128)
            self.b.weight = self.a.weight

    cfg = CommonConfiguration(JAX_TP_RECIPE)
    for module, n, match in ((Grouped(), 2, "cannot be cut into 2 column blocks"),
                             (Grouped(), 4, "cannot be cut into 4 column blocks"),
                             (Tied(), 2, "a.weight .Linear. is shared")):
        state = TrainState(model=module, optimizer=build_optimizer(
            cfg, module, build_lr_scheduler(cfg, 10)))
        before = {k: v.clone() for k, v in module.state_dict().items()}
        with pytest.raises(NotImplementedError, match=match):
            shard_train_state(state, Mesh(data=1, model=n))
        assert all(torch.equal(v, before[k]) for k, v in module.state_dict().items())


def test_spatial_apply_matches_jax_on_four_devices(ranks):
    """(f) ``spatial_apply`` over four ranks against JAX's over
    ``create_mesh(model=4)`` of four devices, on JAX's two test models
    (``test_parallel_spatial.py``: the 3-conv FCN at overlap 4, the
    stride-2 down/up chain at overlap 8) with their Flax weights carried
    across: the whole output, border rows included, within 1e-6 and 1e-5;
    the torch models equal the Flax ones unsplit, so the case holds the
    tiling."""
    from flax import linen as nn

    class DownUp(nn.Module):  # test_parallel_spatial.py's
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Conv(8, (3, 3), strides=2, padding=1, name="down")(x))
            x = nn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME", name="up")(x)
            return nn.Conv(2, (3, 3), padding=1, name="head")(x)

    mesh = jax_mesh.create_mesh(model=W, devices=jax.devices()[:W])
    cases = (("fcn", SmallFCN(), np.random.RandomState(0).rand(2, 8 * W, 16, 3), 4, 1e-6),
             ("down_up", DownUp(), np.random.RandomState(1).rand(1, 16 * W, 12, 3), 8, 1e-5))
    for kind, jm, x, overlap, atol in cases:
        x = x.astype(np.float32)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jax_spatial_apply(lambda t: jm.apply(v, t), jnp.asarray(x), mesh,
                                            axis="model", overlap=overlap))
        params = jax.tree_util.tree_map(np.asarray, v["params"])
        got = ranks.run("job_spatial", kind, params, x, overlap, timeout=30)
        for g in got:
            assert g.shape == want.shape
            np.testing.assert_allclose(g, want, atol=atol, err_msg=kind)
        with torch.no_grad():
            whole = ranks_mod.spatial_model(kind, params)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(whole, np.asarray(jm.apply(v, jnp.asarray(x))), atol=atol,
                                   err_msg=kind)


def test_other_layer_kinds_match_one_process(ranks):
    """(g) At model = 4, float64: a one-group ``ConvTranspose2d`` computes
    column-parallel, a transposed convolution with a forward of its own
    and a table read in the forward are gathered by their pre-hook, and a
    heads-split ``MultiHeadDense`` computes column blocks of each head
    with its bias added whole.  The output within 1e-12 and every
    gradient (gathered) within 1e-10 of one process's; each rank holds
    its blocks (the MultiHeadDense's strided across the heads)."""
    torch.manual_seed(2)
    model = ranks_mod.TPLayers().double()
    weights = ranks_mod.state_arrays(model)
    x = np.random.RandomState(3).randn(2, 16, 8, 8)
    out = ranks.run("job_tp_layers", weights, x, W, timeout=30)
    one = ranks_mod.job_tp_layers(weights, x, 1)
    plan = port_sharded(model, W)
    assert plan == {"up.weight": (1, 1), "up2.weight": (1, 1), "query.weight": (0, 4),
                    "pos": (2, 1)}
    for o in out:
        assert o["classes"] == {"up": "ColumnParallelConvTranspose2d", "up2": "OwnForward",
                                "query": "ColumnParallelMultiHeadDense"}
        np.testing.assert_allclose(o["y"], one["y"], rtol=0, atol=1e-12)
        for name, g in one["grads"].items():
            np.testing.assert_allclose(o["grads"][name], g, rtol=0, atol=1e-10, err_msg=name)
    assert_holds_blocks(out, plan, weights, {n: tuple(p.shape)
                                             for n, p in model.named_parameters()})
