"""Classification losses (counterpart of ``cvpytorch_tpu/models/losses/cls_loss.py``):
functions of (N, C) logits and (N,) integer labels.  Per-class weights
come from the dictionary; label smoothing is ``optax.smooth_labels``'s,
``(1 − α)·onehot + α / C``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...registry import LOSSES


def _weighted_mean(losses, labels, class_weights):
    if class_weights is None:
        return losses.mean()
    w = torch.as_tensor(class_weights, dtype=losses.dtype, device=losses.device)[labels]
    return (losses * w).sum() / torch.clamp(w.sum(), min=1e-8)


@LOSSES.register(name="CrossEntropyLoss")
def cross_entropy_loss(logits, labels, class_weights=None, label_smoothing: float = 0.0):
    labels = labels.long()
    onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / logits.shape[-1]
    losses = -(onehot * F.log_softmax(logits, -1)).sum(-1)
    return _weighted_mean(losses, labels, class_weights)


@LOSSES.register(name="FocalLoss")
def focal_loss(logits, labels, gamma: float = 2.0, alpha: float = 0.25,
               class_weights=None):
    labels = labels.long()
    onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    logp = F.log_softmax(logits, -1)
    focal = -onehot * ((1 - logp.exp()) ** gamma) * logp
    if alpha is not None:
        focal = alpha * focal
    return _weighted_mean(focal.sum(-1), labels, class_weights)


def _sigmoid_bce(logits, targets):
    """``optax.sigmoid_binary_cross_entropy``."""
    return -targets * F.logsigmoid(logits) - (1 - targets) * F.logsigmoid(-logits)


def class_balanced_loss(logits, labels, samples_per_cls, beta: float = 0.9999,
                        gamma: float = 2.0, loss_type: str = "focal"):
    """Class-balanced loss on effective sample numbers (arXiv:1901.05555).
    ``loss_type`` ∈ {'focal', 'sigmoid', 'softmax'}: focal divides by the
    number of one-hot entries, sigmoid and softmax take the weighted mean
    of the binary cross-entropy."""
    c = logits.shape[1]
    spc = torch.as_tensor(samples_per_cls, dtype=torch.float32, device=logits.device)
    w = (1.0 - beta) / (1.0 - torch.pow(torch.tensor(beta, dtype=torch.float32), spc))
    w = w / w.sum() * c
    onehot = F.one_hot(labels.long(), c).to(logits.dtype)
    ex_w = (w[None, :] * onehot).sum(1, keepdim=True)
    if loss_type == "focal":
        modulator = torch.exp(-gamma * onehot * logits
                              - gamma * torch.log1p(torch.exp(-logits)))
        return (ex_w * modulator * _sigmoid_bce(logits, onehot)).sum() / onehot.sum()
    if loss_type == "sigmoid":
        return (ex_w * _sigmoid_bce(logits, onehot)).mean()
    if loss_type == "softmax":
        pred = torch.softmax(logits, -1)
        bce = -(onehot * torch.log(pred.clamp(min=1e-12))
                + (1 - onehot) * torch.log((1 - pred).clamp(min=1e-12)))
        return (ex_w * bce).mean()
    raise ValueError(loss_type)
