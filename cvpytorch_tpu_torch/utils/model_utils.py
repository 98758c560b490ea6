"""Model utilities (counterpart of ``cvpytorch_tpu/utils/model_utils.py``):
SWA, precise BN, conv + BN fusion, class weights and autoanchor k-means.

The JAX package works on pytrees; here ``swa_average`` averages state
dicts and ``precise_bn`` and the fusions change an ``nn.Module`` in place.
The class weights and the anchor functions are numpy, equal to JAX's bit
for bit under one seed.

Two departures from the JAX functions, both on purpose:

* ``fuse_model_conv_bn`` reads each BN's own ``eps``; JAX fuses the whole
  tree with one ``eps`` (1e-3 by default, which is the YOLO bricks' own,
  but not a ResNet's 1e-5).  The BN is replaced by ``nn.Identity`` where
  JAX keeps an identity BN.
* ``precise_bn`` takes each BN input's batch moments directly, in float64,
  and averages them as population statistics: mean = E[batch mean],
  var = E[batch var + batch mean²] − mean², with the biased batch var.
  JAX reads the moments back from the running-stat update, whose var the
  repo's BatchNorm stores with Bessel's factor n / (n − 1), so its var
  carries that factor on the batch-var term.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm


# ---------------------------------------------------------------- SWA ----
def swa_average(state_dicts: Iterable[Mapping[str, torch.Tensor]]) -> dict:
    """Uniform average of N state dicts (float tensors: the sum divided by
    N, as JAX sums its trees; other tensors, such as BN's step counters,
    are taken from the first)."""
    dicts = list(state_dicts)
    n = len(dicts)
    if n == 0:
        raise ValueError("swa_average needs at least one state dict")
    out = {}
    for k, first in dicts[0].items():
        if torch.is_floating_point(first):
            out[k] = sum(d[k] for d in dicts) / float(n)
        else:
            out[k] = first.clone()
    return out


# ------------------------------------------------------------ precise BN --
@torch.no_grad()
def precise_bn(model: nn.Module, batches, mode_kwargs: Mapping | None = None) -> nn.Module:
    """Population BN statistics over ``batches`` (each ``{'image',
    'target'?}``, run as ``model(image, targets=target, mode='train')``),
    written into every BN's ``running_mean``/``running_var`` in place.

    Each BN's input moments are taken in float64 in every forward:
    mean = E[batch mean] and var = E[batch var + batch mean²] − mean²,
    batch var biased.  The model's mode, its BN step counters and every
    other buffer come back as they were; a BN that never ran keeps its
    statistics."""
    bns = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    sums = {id(m): [0.0, 0.0, 0] for m in bns}
    saved = {id(m): (m.running_mean.clone(), m.running_var.clone(),
                     m.num_batches_tracked.clone()) for m in bns}

    def record(module, inputs):
        x = inputs[0].detach().to(torch.float64)
        dims = [d for d in range(x.dim()) if d != 1]
        bm = x.mean(dims)
        bv = x.var(dims, unbiased=False)
        acc = sums[id(module)]
        acc[0] = acc[0] + bm
        acc[1] = acc[1] + bv + bm * bm
        acc[2] += 1

    handles = [m.register_forward_pre_hook(record) for m in bns]
    was_training = model.training
    try:
        model.train()
        for batch in batches:
            model(batch["image"], targets=batch.get("target"), mode="train",
                  **dict(mode_kwargs or {}))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    for m in bns:
        mean0, var0, steps0 = saved[id(m)]
        s_mean, s_sq, n = sums[id(m)]
        m.num_batches_tracked.copy_(steps0)
        if n == 0:
            m.running_mean.copy_(mean0)
            m.running_var.copy_(var0)
            continue
        mean = s_mean / n
        m.running_mean.copy_(mean.to(m.running_mean.dtype))
        m.running_var.copy_((s_sq / n - mean * mean).to(m.running_var.dtype))
    return model


# ------------------------------------------------------ conv + BN fusion --
def fuse_conv_bn(conv_weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var,
                 eps: float = 1e-5):
    """Conv + BN folded into one conv: OIHW weight, and bias (O,)."""
    std = torch.sqrt(bn_var + eps)
    w = conv_weight * (bn_weight / std)[:, None, None, None]
    b = conv_bias if conv_bias is not None else 0.0
    b = (b - bn_mean) * bn_weight / std + bn_bias
    return w, b


@torch.no_grad()
def fuse_model_conv_bn(model: nn.Module) -> nn.Module:
    """Folds every ``conv`` + ``bn`` child pair (the ``ConvBNAct`` layout:
    an ``nn.Conv2d`` named ``conv`` beside a BN named ``bn``) into the
    conv, in place, each with its BN's own ``eps``; the BN becomes
    ``nn.Identity``.  For serving: the model should be in ``eval()``."""
    for module in list(model.modules()):
        conv, bn = getattr(module, "conv", None), getattr(module, "bn", None)
        if not (isinstance(conv, nn.Conv2d) and isinstance(bn, _BatchNorm)):
            continue
        w, b = fuse_conv_bn(conv.weight, conv.bias, bn.weight, bn.bias,
                            bn.running_mean, bn.running_var, bn.eps)
        conv.weight.copy_(w)
        if conv.bias is None:
            conv.bias = nn.Parameter(b.detach().clone())
        else:
            conv.bias.copy_(b)
        module.bn = nn.Identity()
    return model


# ------------------------------------------------------- class weights ---
def seg_class_weights(mask_iter, num_classes: int, ignore_index: int = 255):
    """Log-inverse-frequency segmentation class weights."""
    counts = np.zeros(num_classes, np.float64)
    for mask in mask_iter:
        m = np.asarray(mask).reshape(-1)
        m = m[(m != ignore_index) & (m < num_classes)]
        counts += np.bincount(m, minlength=num_classes)
    freq = counts / max(counts.sum(), 1)
    return 1.0 / (np.log(1.02 + freq))


def det_class_weights(labels_iter, num_classes: int):
    """Inverse-frequency detection class weights, summing to the number
    of classes."""
    counts = np.zeros(num_classes, np.float64)
    for labels in labels_iter:
        counts += np.bincount(np.asarray(labels).reshape(-1), minlength=num_classes)
    counts[counts == 0] = 1
    w = 1.0 / counts
    return w / w.sum() * num_classes


# ----------------------------------------------------------- autoanchor --
def kmean_anchors(wh: np.ndarray, n: int = 9, img_size: int = 640,
                  iters: int = 100, seed: int = 0):
    """k-means anchors over box sizes ``wh`` (N, 2), pixels at
    ``img_size``, under the min-ratio similarity; (n, 2) by area."""
    rng = np.random.RandomState(seed)
    wh = wh[(wh >= 2.0).all(1)]
    idx = rng.choice(len(wh), n, replace=False)
    centers = wh[idx].copy()
    for _ in range(iters):
        r = wh[:, None] / centers[None]
        sim = np.minimum(r, 1 / r).min(-1)  # (N, n)
        assign = sim.argmax(1)
        for k in range(n):
            sel = wh[assign == k]
            if len(sel):
                centers[k] = sel.mean(0)
    return centers[np.argsort(centers.prod(1))]


def check_anchors(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0):
    """Best possible recall: the share of boxes whose best anchor is
    within a factor ``thr`` in both sides."""
    r = wh[:, None] / anchors[None]
    ratio = np.minimum(r, 1 / r).min(-1)
    best = ratio.max(1)
    return float((best > 1 / thr).mean())
