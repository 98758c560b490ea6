"""Steps around the model (counterpart of ``cvpytorch_tpu/train_state.py``).

``TrainState`` holds the model, its optimizer, the EMA copy and the step
count, and the steps change it in place:

* ``make_train_step`` — optional ``preprocess`` (the device augmentation),
  forward in ``mode="train"``, backward, the optimizer's chain, EMA.  AMP
  is ``torch.autocast(dtype=torch.bfloat16)`` around the forward: the
  parameters stay float32 and there is no gradient scaler (bf16 has f32's
  range); the model runs its loss in float32 on the raw maps cast up.
  (The JAX step casts parameters and images to bf16 and runs the loss in
  bf16.)  Without AMP the step is float32 throughout;
* ``make_eval_step`` — ``mode="val"`` under ``inference_mode`` on the EMA
  weights when EMA is on, float32;
* ``make_predict_step`` — serving, ``mode="infer"``, float32.

Both return what the model returns: a detector's dict of padded
detections, a segmentor's (B, H, W) argmax map.  Images stay NHWC.

Every step maker turns both TF32 switches off for the process
(``torch.backends.cudnn.allow_tf32``, on by PyTorch's default, and
``torch.backends.cuda.matmul.allow_tf32``), so a float32 operation is
float32 as in the JAX package.  They are set when the step is made, so a
call changes no global state.

EMA blends the parameters and the BN running statistics with the decay
d·(1 − e^{−(step+1)/2000}) after each update and copies
``num_batches_tracked``.

Data parallelism (``parallel.dist``, a live group of more than one rank):
each rank's loss is its share of the global batch's (the losses' and BN's
normalisers are global), so the train step sums the ranks' gradients
(``all_reduce_sum_``, bucketed, before the optimizer: the clip sees the
global gradient) and their metrics, which are then the global batch's on
every rank; optimizer, EMA and schedule run the same on every rank.  The
sum is explicit rather than DDP's average, which would need the loss
scaled by the world size, prefix the checkpoint's keys with ``module.``
and hook the backward.  The eval step runs under ``local_reductions()``.

Tensor parallelism (a mesh with a ``model`` axis above 1,
``parallel.mesh.shard_train_state``, which sets ``state.mesh``; the step
runs with that mesh current): the gradients are summed over the
data group only (the model ranks hold the same rows), the optimizer and
EMA step each rank's blocks, and after the sum the replicated leaves'
gradients and the BN running statistics are broadcast from the model
group's first rank (``parallel.tensor.broadcast_from_model_root_``, one
bucket of bytes).  Every model rank computes the replicated layers on the
same inputs, but two processes on the card may pick different cuDNN
algorithms for one layer, or reduce a weight gradient in another order,
and the copies would drift apart where JAX holds one value: the broadcast
keeps them identical, at the cost of one collective of the replicated
leaves' size a step.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .parallel import dist as dp
from .parallel import tensor


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: nn.Module | None = None
    step: int = 0
    mesh: object = None  # the parallel.mesh.Mesh it is laid out on (shard_train_state)


def create_train_state(model: nn.Module, optimizer, use_ema: bool = False) -> TrainState:
    ema = copy.deepcopy(model).eval().requires_grad_(False) if use_ema else None
    return TrainState(model=model, optimizer=optimizer, ema=ema)


def ema_decay_schedule(base_decay: float, step: int, tau: float = 2000.0) -> float:
    """Warmup-ramped EMA decay."""
    return base_decay * (1.0 - math.exp(-step / tau))


@torch.no_grad()
def ema_blend(ema_tensors, tensors, d: float) -> None:
    """e ← d·e + (1 − d)·p in place, with d rounded to float32 first as
    the JAX step computes it."""
    d = float(np.float32(d))
    torch._foreach_mul_(ema_tensors, d)
    torch._foreach_add_(ema_tensors, torch._foreach_mul(tensors, 1.0 - d))


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, d: float) -> None:
    """Blends parameters and BN running statistics; copies
    ``num_batches_tracked``."""
    blend_e, blend_p = list(ema.parameters()), list(model.parameters())
    for (name, eb), b in zip(ema.named_buffers(), model.buffers()):
        if name.endswith("num_batches_tracked"):
            eb.copy_(b)
        else:
            blend_e.append(eb)
            blend_p.append(b)
    ema_blend(blend_e, blend_p, d)


def bn_statistics(model: nn.Module) -> list[torch.Tensor]:
    """The BN layers' running means and variances."""
    return [b for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var) if b is not None]


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches become [0, 1] float32 on the device; float batches
    pass through as float32."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    if images.is_floating_point():
        return images.to(torch.float32)
    return images


def _float32_everywhere() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_train_step(amp: bool = False, ema_decay: float = 0.0, preprocess=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``state``
    is updated in place and ``metrics`` are 0-dim float32 tensors on the
    device, not synchronised.  ``preprocess`` (``batch -> batch``) runs
    first, on the device: the device augmentation."""
    _float32_everywhere()

    def train_step(state: TrainState, batch):
        with dp.using_mesh(state.mesh):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch):
        if preprocess is not None:
            batch = preprocess(batch)
        model = state.model.train()
        images = prepare_images(batch["image"])
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=amp):
            total, loss_dict = model(images, targets=batch.get("target"),
                                     mode="train")
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        split, tp = dp.reductions_active(), state.mesh is not None and state.mesh.model > 1
        if split or tp:
            params = [p for g in state.optimizer.param_groups for p in g["params"]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if split:
            dp.all_reduce_sum_([p.grad for p in params])
        if tp:  # the replicated leaves as the model group's first rank has them
            tensor.broadcast_from_model_root_(
                [p.grad for p in params if not tensor.is_sharded(p)] + bn_statistics(model),
                state.mesh)
        state.optimizer.step()
        if state.ema is not None and ema_decay > 0:
            ema_update(state.ema, model, ema_decay_schedule(ema_decay, state.step + 1))
        state.step += 1
        metrics = {"loss": total.detach()}
        for k, v in loss_dict.items():
            metrics[k] = torch.as_tensor(v, dtype=torch.float32,
                                         device=images.device).detach()
        if split:  # the ranks' shares of each term sum to the global batch's
            names = list(metrics)
            summed = torch.stack([metrics[k] for k in names])
            dp.all_reduce_sum_([summed])
            metrics = dict(zip(names, summed.unbind()))
        return state, metrics

    return train_step


def make_eval_step(use_ema: bool = False):
    """Returns ``eval_step(state, batch) -> (loss_dict, predictions)``."""
    _float32_everywhere()

    def eval_step(state: TrainState, batch):
        model = state.ema if (use_ema and state.ema is not None) else state.model
        model.eval()
        with torch.inference_mode(), dp.local_reductions():
            return model(prepare_images(batch["image"]),
                         targets=batch.get("target"), mode="val")

    return eval_step


def make_predict_step(model: nn.Module):
    """Returns ``predict_step(images, targets=None) -> predictions``: the
    model in ``eval()`` under ``torch.inference_mode()``, float32, on the
    device the images are on.  ``targets`` (a detector's letterbox
    ``pads``/``scales``) go to the model as they are."""
    _float32_everywhere()

    def predict_step(images: torch.Tensor, targets=None):
        model.eval()
        with torch.inference_mode():
            return model(prepare_images(images), targets, mode="infer")

    return predict_step
