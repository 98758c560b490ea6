"""The port's FastestDet (its SPP and head, the SIoU loss with the
above-mean filter, the double sigmoid and the last-writer factor map)
against the JAX package on the CPU, with one set of weights carried
across by ``load_jax_variables``, at 128² (8² cells).

Tolerances: the factor-map scatter equal; the loss terms within 1e-9
relative (float64); the raw outputs within 1e-4 of their largest value
(float32, eval mode); train-mode losses 1e-9 and every gradient leaf 1e-6
of its largest value (float64); val losses and predictions as
``test_torch_yolox.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import yolop as jax_yolop
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import yolop
from tests.test_torch_nanodet_v1 import assert_close_to_scale
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolox import (B, DICTIONARY, check_train_losses_and_grads,
                                    check_val_and_infer, images, make_pair, targets,
                                    torch_targets, trains_validates_and_serves)

C = len(DICTIONARY)
HW = 128


# -- the factor map and the loss --------------------------------------------------------------
def test_last_writer_scatter_matches_jax():
    """Repeated cells with mixed values: each cell takes its last
    candidate's value, as JAX's CPU scatter-set does."""
    rng = np.random.RandomState(0)
    cells = rng.randint(0, 6, (B, 20))
    values = np.where(rng.rand(B, 20) > 0.5, 0.75, rng.rand(B, 20) * 10)
    want = jax.jit(jax.vmap(lambda c, v: jnp.full(9, 0.75).at[c].set(v)))(
        jnp.asarray(cells), jnp.asarray(values, jnp.float32))
    got = yolop.last_writer_scatter(torch.full((B, 9), 0.75), torch.from_numpy(cells),
                                    torch.from_numpy(values.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 6:] == 0.75).all()


def fastest_targets(seed, hw=128):
    """Eight gts an image on 128²'s 8×8 cells: quadrants overlap, so
    cells repeat across gts (with ``keep`` true for some, false for
    others); image 1's last two are padding."""
    r = np.random.RandomState(seed)
    c = r.uniform(20, hw - 20, (B, 8, 2))
    wh = r.uniform(10, 50, (B, 8, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).clip(0, hw)
    valid = np.ones((B, 8), bool)
    valid[1, 6:] = False
    return {"boxes": boxes, "labels": r.randint(0, C, (B, 8)).astype(np.int32), "valid": valid}


@pytest.mark.parametrize("seed", [0, 1])
def test_fastestdet_loss_matches_jax(seed, monkeypatch):
    """The loss on random head outputs (probabilities where the model puts
    them), float64, with repeated cells of mixed ``keep``: a cell written
    by a kept candidate (its image's balanced factor) and by one not kept
    (0.75)."""
    writes = []
    scatter = yolop.last_writer_scatter
    monkeypatch.setattr(yolop, "last_writer_scatter",
                        lambda b, i, v: writes.append((i, v)) or scatter(b, i, v))
    rng = np.random.RandomState(seed)
    obj = 1 / (1 + np.exp(-rng.randn(B, 8, 8, 1)))
    cls = np.exp(rng.randn(B, 8, 8, C))
    pred = np.concatenate([obj, rng.randn(B, 8, 8, 4), cls / cls.sum(-1, keepdims=True)], -1)
    t = fastest_targets(seed)
    jm = jax_yolop.FastestDet(dictionary=DICTIONARY)
    with jax.enable_x64(True):
        _, want = jax.jit(lambda p, tt: jm.apply({}, p, tt, method=lambda m, a, b: m._loss(
            a, b)))(jnp.asarray(pred), {k: jnp.asarray(v) for k, v in t.items()})
        want = {k: float(v) for k, v in want.items() if k != "loss"}
    tm = yolop.FastestDet(dictionary=DICTIONARY)
    _, got = tm._loss(torch.from_numpy(pred), torch_targets(t))
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9, err_msg=k)
    (cells, values), = writes
    mixed = [len({float(v) == 0.75 for v in values[b][cells[b] == c]}) == 2
             for b in range(B) for c in cells[b].unique()]
    assert any(mixed)


# -- the model ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_yolop.FastestDet, yolop.FastestDet, {}, HW, t=targets(HW))


def test_raw_outputs_match_jax(pair):
    """[sigmoid(obj), reg, softmax(cls)] at stride 16, eval mode."""
    jm, variables, tm = pair
    x = images(HW)
    want = jax.jit(lambda v, a: jm.apply(v, a, method=lambda m, i: m._raw(i, False)))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm._raw(torch.from_numpy(x))
    assert got.shape == (B, 8, 8, 5 + C)
    assert_close_to_scale(got.numpy(), np.asarray(want))


def test_train_loss_and_grads_match_jax(pair):
    jm, variables, tm = pair
    check_train_losses_and_grads(jm, variables, tm, images(HW), targets(HW),
                                 ("box_loss", "obj_loss", "cls_loss"))


def test_val_and_infer_predictions_match_jax(pair):
    jm, variables, tm = pair
    check_val_and_infer(jm, variables, tm, images(HW, seed=1), targets(HW), min_valid=10)


def test_config_trains_validates_and_serves(tmp_path):
    """``coco_fastestdet`` names ``src.models.fastestdet.FastestDet``: the
    registry resolves it to the class in ``yolop.py``, as in JAX."""
    cfg = CommonConfiguration.from_file("conf/coco_fastestdet.yml")
    with torch.device("meta"):
        assert type(infer.build_model(cfg, DICTIONARY)) is yolop.FastestDet
    trains_validates_and_serves(tmp_path, "coco_fastestdet", size=HW)
