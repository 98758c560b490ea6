"""Segmentation losses (counterpart of
``cvpytorch_tpu/models/losses/seg_loss.py``).

Each takes ``logits`` (B, C, H, W) (the JAX functions take NHWC) and
integer ``labels`` (B, H, W) with an ``ignore_index`` (255 for
Cityscapes), and is a mean over the valid pixels with the same weights as
the JAX function.  Ignored pixels stay in every tensor with weight 0, so
shapes do not depend on the data.

Under data parallelism (``parallel.dist``) each rank's loss is its share
of the global batch's: the weighted means divide by the weight summed over
the ranks of the data group, and the Dice sums are all-reduced (with
autograd) and the Dice loss split evenly over them, so their losses sum to
the global loss (the ranks of one model group hold the same rows and count
them once).  OHEM and Lovász-softmax rank the pixels of the whole batch and are
refused there (ROADMAP, Queue 1 item 11c).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from ...parallel import dist as dp
from ...registry import LOSSES


def _refuse_split(name: str):
    if dp.reductions_active():
        raise NotImplementedError(
            f"{name} ranks the pixels of the whole batch: under data parallelism it is "
            "not ported yet (ROADMAP, Queue 1 item 11c)")


def _valid_mask(labels, ignore_index):
    return (labels != ignore_index).float()


def _safe_labels(labels, ignore_index):
    return torch.where(labels == ignore_index, 0, labels).long()


def _gather(x, safe):
    """x (B, C, H, W) at the label of each pixel → (B, H, W)."""
    return x.gather(1, safe[:, None])[:, 0]


def _weighted_mean(loss, w, safe, class_weights):
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=w.dtype, device=w.device)[safe]
    return (loss * w).sum() / torch.clamp(dp.global_sum(w.sum()), min=1.0)


@LOSSES.register(name="CrossEntropyLoss2d")
def cross_entropy_2d(logits, labels, class_weights=None, ignore_index: int = 255,
                     label_smoothing: float = 0.0):
    safe = _safe_labels(labels, ignore_index)
    ce = F.cross_entropy(logits, safe, reduction="none",
                         label_smoothing=float(label_smoothing))
    return _weighted_mean(ce, _valid_mask(labels, ignore_index), safe, class_weights)


@LOSSES.register(name="OhemCrossEntropyLoss2d")
def ohem_cross_entropy_2d(logits, labels, thresh: float = 0.7,
                          min_kept_ratio: float = 0.05,
                          class_weights=None, ignore_index: int = 255):
    """Cross-entropy over the hard pixels: those whose probability of the
    true class is at most max(thresh, the ``min_kept``-th smallest such
    probability), ``min_kept`` a ratio of all pixels."""
    _refuse_split("OhemCrossEntropyLoss2d")
    mask = _valid_mask(labels, ignore_index)
    safe = _safe_labels(labels, ignore_index)
    logp_gt = _gather(F.log_softmax(logits, 1), safe)
    prob_gt = torch.exp(logp_gt)
    flat_prob = torch.where(mask > 0, prob_gt, 1.0).reshape(-1)
    min_kept = max(int(flat_prob.numel() * min_kept_ratio), 1)
    kth = torch.kthvalue(flat_prob.detach(), min_kept).values
    eff_thresh = torch.clamp(kth, min=thresh)
    hard = (prob_gt <= eff_thresh).float() * mask
    return _weighted_mean(-logp_gt, hard, safe, class_weights)


@LOSSES.register(name="BCEWithLogitsLoss2d")
def bce_2d(logits, labels, ignore_index: int = 255):
    """Binary segmentation: ``logits`` (B, 1, H, W)."""
    mask = _valid_mask(labels, ignore_index)
    y = torch.clamp(labels.float(), 0, 1)
    x = logits[:, 0]
    loss = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))
    return (loss * mask).sum() / torch.clamp(dp.global_sum(mask.sum()), min=1.0)


@LOSSES.register(name="DiceLoss")
def dice_loss(logits, labels, smooth: float = 1.0, ignore_index: int = 255):
    num_classes = logits.shape[1]
    mask = _valid_mask(labels, ignore_index)[:, None]
    probs = torch.softmax(logits, 1) * mask
    onehot = F.one_hot(_safe_labels(labels, ignore_index), num_classes)
    onehot = onehot.permute(0, 3, 1, 2).to(probs.dtype) * mask
    dims = (0, 2, 3)
    sums = dp.all_reduce_with_grad(torch.stack([
        (probs * onehot).sum(dims), probs.sum(dims) + onehot.sum(dims)]))
    inter, denom = sums[0], sums[1]
    dice = (2 * inter + smooth) / (denom + smooth)
    loss = 1.0 - dice.mean()
    return loss / dp.data_size() if dp.reductions_active() else loss


@LOSSES.register(name="FocalLoss2d")
def focal_loss_2d(logits, labels, gamma: float = 2.0, alpha: float = 0.25,
                  class_weights=None, ignore_index: int = 255):
    safe = _safe_labels(labels, ignore_index)
    logp_gt = _gather(F.log_softmax(logits, 1), safe)
    loss = -alpha * ((1 - torch.exp(logp_gt)) ** gamma) * logp_gt
    return _weighted_mean(loss, _valid_mask(labels, ignore_index), safe, class_weights)


@LOSSES.register(name="LovaszSoftmax")
def lovasz_softmax(logits, labels, ignore_index: int = 255):
    """Lovász-softmax over the classes present in the labels.  Every class
    sorts its errors at once, stably (as ``jnp.argsort``), so pixels with
    equal errors take the JAX order; ignored pixels get error 0."""
    _refuse_split("LovaszSoftmax")
    num_classes = logits.shape[1]
    probs = torch.softmax(logits, 1).permute(1, 0, 2, 3).reshape(num_classes, -1)
    labels_f = labels.reshape(-1)
    valid = labels_f != ignore_index
    safe = torch.where(valid, labels_f, 0)
    classes = torch.arange(num_classes, device=logits.device)[:, None]
    fg = ((safe[None] == classes) & valid[None]).float()  # (C, N)
    errors = torch.where(valid[None], torch.abs(fg - probs), 0.0)
    errors_sorted, order = torch.sort(errors, dim=1, descending=True, stable=True)
    fg_sorted = fg.gather(1, order)
    gts = fg_sorted.sum(1, keepdim=True)
    intersection = gts - torch.cumsum(fg_sorted, 1)
    union = gts + torch.cumsum(1.0 - fg_sorted, 1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-8)
    jaccard = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], 1)
    present = (gts[:, 0] > 0).float()
    losses = (errors_sorted * jaccard).sum(1) * present
    return losses.sum() / torch.clamp(present.sum(), min=1.0)


@LOSSES.register(name="CrossEntropyDiceLoss")
def ce_dice_loss(logits, labels, dice_weight: float = 1.0,
                 class_weights=None, ignore_index: int = 255):
    return cross_entropy_2d(logits, labels, class_weights, ignore_index) + \
        dice_weight * dice_loss(logits, labels, ignore_index=ignore_index)


SEG_LOSSES = {
    "CrossEntropyLoss2d": cross_entropy_2d,
    "OhemCrossEntropyLoss2d": ohem_cross_entropy_2d,
    "BCEWithLogitsLoss2d": bce_2d,
    "DiceLoss": dice_loss,
    "FocalLoss2d": focal_loss_2d,
    "LovaszSoftmax": lovasz_softmax,
    "CrossEntropyDiceLoss": ce_dice_loss,
}


def build_seg_loss(name: str, **kwargs):
    fn = SEG_LOSSES[name]
    return partial(fn, **kwargs) if kwargs else fn
