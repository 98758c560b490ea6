"""Steps around the model (counterpart of ``cvpytorch_tpu/train_state.py``).

This slice holds the serving side: ``prepare_images`` and the predict
step.  The train and eval steps come with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches become [0, 1] float32 on the device; float batches
    pass through as float32."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    if images.is_floating_point():
        return images.to(torch.float32)
    return images


def make_predict_step(model: nn.Module):
    """Returns ``predict_step(images) -> predictions``: the model in
    ``eval()`` under ``torch.inference_mode()``, float32, on the device the
    images are on.

    Serving is float32, as the JAX predict step is, so making the step
    turns off both TF32 switches for the process:
    ``torch.backends.cudnn.allow_tf32`` (on by PyTorch's default) and
    ``torch.backends.cuda.matmul.allow_tf32``.  They are set once, when the
    step is made, so that a call changes no global state."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def predict_step(images: torch.Tensor):
        model.eval()
        with torch.inference_mode():
            return model(prepare_images(images), mode="infer")

    return predict_step
