"""The port's deploy path against the JAX package on the CPU: the
``cvt::nms_keep`` op, conv + BN fusion, the exported YOLOv5 program and
the ``exports`` CLI.

Tolerances: raw maps of fused and unfused models within 1e-4 of their
largest value (float32 rounding of the folded weights); exported
detections against JAX's deserialized StableHLO as the eager infer test
holds them (labels, valid and num equal; boxes and scores within 1e-4);
the exported program against the eager port model in the same
channels-last layout bit for bit (the same CPU kernels).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.exports import export_stablehlo, load_stablehlo
from cvpytorch_tpu.models.backbones.mobilenetv2 import MobileNetV2 as JaxMobileNetV2
from cvpytorch_tpu.utils.model_utils import fuse_model_conv_bn as jax_fuse
from cvpytorch_tpu_torch import exports
from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
from cvpytorch_tpu_torch.infer import build_model
from cvpytorch_tpu_torch.models.backbones.mobilenetv2 import MobileNetV2
from cvpytorch_tpu_torch.ops.nms_cases import nms_inputs
from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
from cvpytorch_tpu_torch.train_state import create_train_state
from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints
from cvpytorch_tpu_torch.utils.model_utils import fuse_model_conv_bn
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_rcnn_ops import init_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolov5 import images, make_pair

SETTING = "conf/coco_yolov5_s.yml"


def nms_nodes(program):
    return [n for n in program.graph.nodes if "cvt.nms_keep" in str(n.target)]


def test_nms_keep_is_one_torch_library_op():
    """``cvt::nms_keep`` is registered with a fake kernel (opcheck's schema,
    fake-tensor and dispatch checks pass), gives ``nms_keep_plain`` on the
    CPU without a launch, and keeps the wrapper's refusals."""
    boxes = torch.from_numpy(nms_inputs(2, 200, seed=3))
    before = nms_keep.launches
    assert torch.equal(torch.ops.cvt.nms_keep(boxes, 0.6), nms_keep_plain(boxes, 0.6))
    assert torch.equal(nms_keep(boxes, 0.6), nms_keep_plain(boxes, 0.6))
    assert nms_keep.launches == before
    torch.library.opcheck(torch.ops.cvt.nms_keep.default, (boxes, 0.6))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = mode.from_tensor(boxes)
        out = torch.ops.cvt.nms_keep(fake, 0.6)
    assert out.shape == (2, 200) and out.dtype == torch.bool
    with pytest.raises(ValueError, match="K <= 1024"):
        torch.ops.cvt.nms_keep(torch.zeros(1, 1025, 4), 0.5)


@pytest.fixture(scope="module")
def pair_n():
    return make_pair("yolov5_n", seed=4)


def test_fusion_matches_jax_fusion_on_yolov5(pair_n):
    """Every YOLOv5 BN has eps 1e-3, JAX's one eps: the port's fused raw
    maps equal JAX's fused ones and both equal the unfused model's."""
    jm, variables, tm = pair_n
    x = images(3)
    fp, fs = jax_fuse(variables["params"], variables["batch_stats"])
    raw_j = jax.jit(lambda v, a: jm.apply(v, a, method=lambda m, y: m._raw(y, False)))
    jf = raw_j({"params": fp, "batch_stats": fs}, jnp.asarray(x))
    fused = fuse_model_conv_bn(copy.deepcopy(tm).eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    with torch.no_grad():
        got = fused._raw(torch.from_numpy(x))
        unfused = tm._raw(torch.from_numpy(x))
    for g, w, u in zip(got, jf, unfused):
        scale = np.abs(u.numpy()).max()
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4 * scale
        assert np.abs(g.numpy() - u.numpy()).max() <= 1e-4 * scale


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_fusion_reads_each_bn_eps():
    """MobileNetV2's ConvBNAct BNs have eps 1e-5: the port's fusion reads
    it and keeps the model's outputs; JAX's fusion uses its one eps (1e-3
    by default), off by the difference, and agrees when handed 1e-5."""
    jm = JaxMobileNetV2(width_mult=0.35, classifier=True, num_classes=5)
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    variables = init_tree(jm, jnp.asarray(x), seed=6)
    # variances near 1e-3, where eps matters, and scales √var that keep the
    # activations of order 1 through the 52 BNs
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 1e-3 if p[-1].key == "var" else a, variables)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: np.sqrt(_leaf(variables["batch_stats"], p[:-1])["var"])
        if p[-1].key == "scale" else a, variables["params"])
    tm = load_jax_variables(MobileNetV2(width_mult=0.35, classifier=True, num_classes=5),
                            variables).eval()
    fused = fuse_model_conv_bn(copy.deepcopy(tm))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    with torch.no_grad():
        want = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        got = fused(torch.from_numpy(x).permute(0, 3, 1, 2))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
    apply = jax.jit(lambda v, a: jm.apply(v, a))
    for eps, close in ((1e-3, False), (1e-5, True)):
        p, s = jax_fuse(variables["params"], variables["batch_stats"], eps=eps)
        err = np.abs(np.asarray(apply({"params": p, "batch_stats": s}, jnp.asarray(x)))
                     - want).max()
        assert (err <= 1e-4 * scale) == close, (eps, err)


def test_exported_program_matches_jax_stablehlo(pair_n, tmp_path):
    """The same weights and input: JAX's ``export_stablehlo`` →
    ``load_stablehlo`` → call, against the port's ``export_torch`` →
    ``load_exported`` → call; the graph calls ``cvt.nms_keep`` once."""
    jm, variables, tm = pair_n
    x = images(0)
    path = export_stablehlo(jm.apply, variables, x.shape, str(tmp_path / "m.hlo"))
    jd = load_stablehlo(path).call(jnp.asarray(x))
    program = exports.export_program(copy.deepcopy(tm), x.shape, device="cpu")
    assert len(nms_nodes(program)) == 1
    out = exports.export_torch(copy.deepcopy(tm), x.shape, str(tmp_path / "m.pt2"),
                              device="cpu")
    with torch.no_grad():
        td = exports.load_exported(out)(torch.from_numpy(x))
        eager = copy.deepcopy(tm).to(memory_format=torch.channels_last)(
            torch.from_numpy(x), mode="infer")
    for key in ("labels", "valid", "num"):
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(td[key].numpy(), np.asarray(jd[key]), atol=1e-4, rtol=1e-4)
    for key in td:
        assert torch.equal(td[key], eager[key]), key
    assert int(td["num"].min()) > 0


def test_cli_exports_a_trainer_checkpoint_with_its_ema_weights(tmp_path):
    """``python -m cvpytorch_tpu_torch.exports --setting
    conf/coco_yolov5_s.yml --checkpoint <port ckpt> --fuse`` at 128², batch
    2, on the CPU: the program serves what the fused EMA model serves."""
    cfg = CommonConfiguration.from_file(SETTING)
    _, dictionary = load_dictionary(cfg.DATASET.DICTIONARY, cfg.DATASET.DICTIONARY_NAME)
    torch.manual_seed(0)
    model = build_model(cfg, dictionary)
    state = create_train_state(model, build_optimizer(cfg, model, lambda s: 0.01), use_ema=True)
    with torch.no_grad():
        for p in state.ema.parameters():
            p.mul_(0.9)
        for m in state.ema.modules():  # statistics away from their init
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
        for m in state.ema.detect.modules():  # class scores that clear the threshold
            if isinstance(m, torch.nn.Conv2d):
                m.bias.fill_(0.0)
    ckpts = Checkpoints(str(tmp_path / "ckpts"))
    ckpts.save_checkpoint(state, extra={"epoch": 0})
    ckpt = os.path.join(ckpts.save_dir, "last.pt")
    out = exports.main(["--setting", SETTING, "--checkpoint", ckpt, "--out",
                        str(tmp_path / "yolov5_s"), "--input-size", "128", "128",
                        "--batch", "2", "--fuse", "--device", "cpu"])
    assert out == str(tmp_path / "yolov5_s.pt2")
    program = torch.export.load(out)
    assert len(nms_nodes(program)) == 1
    x = torch.from_numpy(np.random.RandomState(7).rand(2, 128, 128, 3).astype(np.float32))
    want_model = fuse_model_conv_bn(copy.deepcopy(state.ema).eval()).to(
        memory_format=torch.channels_last)  # as exported
    with torch.no_grad():
        got, want = program.module()(x), want_model(x, mode="infer")
    assert int(want["num"].min()) > 0
    for key in ("labels", "valid", "num"):
        assert torch.equal(got[key], want[key]), key
    for key in ("boxes", "scores"):
        torch.testing.assert_close(got[key], want[key], atol=1e-5, rtol=1e-5)
    with pytest.raises(SystemExit):
        exports.main(["--setting", SETTING, "--checkpoint", ckpt, "--format", "onnx"])


def test_export_defaults_to_the_card(pair_n):
    """Without a device the export asks for the card and does not fall back
    to the CPU; the caller's model stays where it was."""
    _, _, tm = pair_n
    model = copy.deepcopy(tm)
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exports.export_program(model, images(0).shape)
    assert next(model.parameters()).device.type == "cpu"
