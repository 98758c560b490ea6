"""The port's GiraffeDet (its space-to-depth backbone, the GiraffeNeck and
the GFLv2 head without groups) against the JAX package on the CPU, with
one set of weights carried across by ``load_jax_variables``.

Tolerances: ``space_to_depth`` equal; the head outputs within 1e-4 of
their largest value (float32, eval mode); the train-mode losses 1e-9 and
every gradient leaf 1e-6 of its largest value (float64); val losses and
predictions as ``test_torch_yolox.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpytorch_tpu.models import giraffedet as jax_giraffedet
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import giraffedet
from tests.test_torch_gflv2_detectors import HW, REG_MAX, nhwc
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_tan import nchw
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, check_train_losses_and_grads,
                                    check_val_and_infer, images, make_pair, targets,
                                    trains_validates_and_serves)

C = len(DICTIONARY)


def test_space_to_depth_orders_channels_as_jax():
    """A channel-distinct input (value = 1000·c + 10·y + x): the new
    channels are (dy, dx, c), not ``F.pixel_unshuffle``'s (c, dy, dx)."""
    c, h, w = 3, 4, 6
    x = (1000 * np.arange(c)[None, None, :] + 10 * np.arange(h)[:, None, None]
         + np.arange(w)[None, :, None]).astype(np.float32)[None]
    want = np.asarray(jax_giraffedet.space_to_depth(jnp.asarray(x)))
    got = giraffedet.space_to_depth(nchw(x))
    np.testing.assert_array_equal(nhwc(got), want)
    assert not torch.equal(got, F.pixel_unshuffle(nchw(x), 2))
    assert float(got[0, 1, 0, 0]) == 1000.0 and float(got[0, c, 0, 0]) == 1.0


@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_giraffedet.GiraffeDet, giraffedet.GiraffeDet, {"TYPE": "giraffedet_s"},
                     HW)


def test_head_outputs_match_jax(pair):
    jm, variables, tm = pair
    x = images(HW)
    jc, jr, jp = jax.jit(lambda v, a: jm.apply(v, a, False, method=lambda m, i, tr: m._outs(
        i, tr)))(variables, jnp.asarray(x))
    with torch.no_grad():
        tc, tr, tp = tm._outs(torch.from_numpy(x))
    assert tc.shape == (B, 84, C) and tr.shape == (B, 84, 4, REG_MAX + 1)
    assert tm.backbone.channels == (192, 384, 384) and tm.head.cls0_0.conv.groups == 1
    assert_close_to_scale(tc.numpy(), jc)
    assert_close_to_scale(tr.numpy(), jr)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_train_loss_and_grads_match_jax(pair):
    jm, variables, tm = pair
    check_train_losses_and_grads(jm, variables, tm, images(HW), targets(HW),
                                 ("qfl_loss", "bbox_loss", "dfl_loss"))


def test_val_and_infer_predictions_match_jax(pair):
    jm, variables, tm = pair
    check_val_and_infer(jm, variables, tm, images(HW, seed=1), targets(HW))


def test_giraffedet_m_builds_the_jax_model():
    kw = dict(dictionary=DICTIONARY, model_cfg={"TYPE": "giraffedet_m"})
    shapes = jax.eval_shape(lambda: jax_giraffedet.GiraffeDet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        m = giraffedet.GiraffeDet(**kw)
    assert sum(v.numel() for k, v in m.state_dict().items()
               if not k.endswith("num_batches_tracked")) == want


def test_config_trains_validates_and_serves(tmp_path):
    cfg = CommonConfiguration.from_file("conf/coco_giraffedet.yml")
    with torch.device("meta"):
        assert type(infer.build_model(cfg, DICTIONARY)) is giraffedet.GiraffeDet
    trains_validates_and_serves(tmp_path, "coco_giraffedet")
