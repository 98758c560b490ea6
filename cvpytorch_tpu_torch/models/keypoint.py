"""Keypoint models (counterpart of ``cvpytorch_tpu/models/keypoint.py``):
OpenPose, SimplePose and LitePose, registered under the JAX names (the
configs' ``src.models.openpose.OpenPose`` and ``src.models.litepose.LitePose``
resolve by their last component).

Images enter NHWC; the networks run NCHW on the ``channels_last`` view
and return NHWC maps, as the JAX models do.

* ``OpenPose`` — backbone (default VGG16-bn to conv4_3) → ``feat_conv`` →
  ``num_stages`` pairs of ``PoseStage``s (heatmaps of 18 joints and the
  background, PAFs of 19 limbs), each stage fed the features and the last
  stage's maps.  The loss is the masked MSE of every stage against the
  targets that ``ops/paf.render_openpose_targets`` renders from the
  collated (B, M, 17, 3) keypoints (float32, autocast off, the
  ``openpose_targets`` range).  ``mode="val"`` also runs the peaks, pair
  scoring and greedy matching on the device; the evaluator assembles the
  people.
* ``SimplePose`` — a backbone and three 4×4 stride-2 transposed
  convolutions to heatmaps; loss against ``targets['heatmaps']``.
* ``LitePose`` — a backbone and a fusion-deconv ladder (transposed
  convolution, BN, a 1×1 lateral of the matching backbone stage, a 7×7
  depthwise and a 1×1 ConvBNAct), the last ``num_outputs`` scales each
  supervised against gaussians of single-instance (B, K, 2|3) keypoints
  rendered at its scale.  The detection collate's (B, M, K, 3) keypoints
  are refused, as is an input side that is not a multiple of 32 (368²,
  the configs' size: a stride-32 map of 12 does not fuse with 23), each
  where the JAX model fails to broadcast.

The transposed convolutions are ``ConvTranspose4x2``: four 2×2
convolutions interleaved, no atomics, so that a served argmax does not
move between calls on the card.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops import paf as paf_ops
from ..registry import MODELS
from .backbones import build_backbone
from .bricks import BatchNorm2d, ConvBNAct
from .heads.seg_heads import resize_linear
from .segmentor import feature_channels

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)  # flax momentum 0.9


def _cfg_get(cfg, key, default=None):
    return cfg.get(key, default) if hasattr(cfg, "get") else default


class ConvTranspose4x2(nn.ConvTranspose2d):
    """Flax's ``ConvTranspose(cout, (4, 4), strides=(2, 2))`` ('SAME'):
    ``ConvTranspose2d(cin, cout, 4, 2, padding=1)`` with the Flax kernel
    flipped (``utils/porting``).  Output row 2m + a is a 2-tap
    convolution of the input padded by one: rows m, m + 1 with kernel
    rows 3, 1 (a = 0) or rows m + 1, m + 2 with rows 2, 0 (a = 1); the
    same for columns."""

    _TAPS = ((3, 1), (2, 0))

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, 2, padding=1)

    def forward(self, x):
        B, _, H, W = x.shape
        w = self.weight.transpose(0, 1)  # (cout, cin, ky, kx)
        xp = F.pad(x, (1, 1, 1, 1))
        rows = []
        for a, ky in enumerate(self._TAPS):
            cols = [F.conv2d(xp[..., a:a + H + 1, b:b + W + 1], w[:, :, ky][:, :, :, kx])
                    for b, kx in enumerate(self._TAPS)]
            rows.append(torch.stack(cols, -1))
        y = torch.stack(rows, 3).reshape(B, -1, 2 * H, 2 * W)
        return y + self.bias.to(y.dtype)[:, None, None]


def render_gaussian_heatmaps(keypoints, valid, hw, sigma: float = 2.0):
    """keypoints (B, K, 2) in heatmap pixels; valid (B, K) → (B, h, w, K)."""
    h, w = hw
    ys = torch.arange(h, dtype=keypoints.dtype, device=keypoints.device)
    xs = torch.arange(w, dtype=keypoints.dtype, device=keypoints.device)
    d2 = (xs[None, None, :, None] - keypoints[:, None, None, :, 0]) ** 2 + \
        (ys[None, :, None, None] - keypoints[:, None, None, :, 1]) ** 2
    hm = torch.exp(-d2 / (2 * sigma ** 2))
    return hm * valid.to(hm.dtype)[:, None, None, :]


def decode_heatmaps(hm):
    """(B, h, w, K) → (B, K, 3): argmax x, y (heatmap pixels, the first
    maximum) and the maximum."""
    B, h, w, K = hm.shape
    flat = hm.reshape(B, h * w, K)
    conf, idx = flat.amax(1), flat.argmax(1)
    return torch.stack([(idx % w).to(hm.dtype), (idx // w).to(hm.dtype), conf], -1)


def keypoints_to_instances(kpts, in_hw, hm_hw, targets=None, vis_threshold: float = 0.2):
    """``decode_heatmaps`` output → one instance per image for the OKS
    COCO evaluator: keypoints in original image pixels (un-letterboxed by
    the targets' ``pads``/``scales``), the box over the confident
    keypoints, score the mean confidence, visibility 2 where confident."""
    B, K, _ = kpts.shape
    sy = in_hw[0] / hm_hw[0]
    sx = in_hw[1] / hm_hw[1]
    x = kpts[..., 0] * sx
    y = kpts[..., 1] * sy
    c = kpts[..., 2]
    if targets is not None and "pads" in targets:
        x = (x - targets["pads"][:, 0:1]) / targets["scales"][:, 0:1]
        y = (y - targets["pads"][:, 1:2]) / targets["scales"][:, 1:2]
    vis = c > vis_threshold
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    x1 = torch.where(vis, x, inf).amin(1)
    x2 = torch.where(vis, x, -inf).amax(1)
    y1 = torch.where(vis, y, inf).amin(1)
    y2 = torch.where(vis, y, -inf).amax(1)
    any_vis = vis.any(1)
    boxes = torch.where(any_vis[:, None], torch.stack([x1, y1, x2, y2], -1),
                        torch.zeros((), dtype=x.dtype, device=x.device))[:, None, :]
    out_kpts = torch.stack([x, y, vis.to(x.dtype) * 2.0], -1)[:, None]
    return {"boxes": boxes, "scores": c.mean(1, keepdim=True),
            "labels": torch.zeros((B, 1), dtype=torch.int32, device=x.device),
            "valid": any_vis[:, None], "keypoints": out_kpts}


class PoseStage(nn.Module):
    """``n_convs`` ConvBNAct (3×3 first, then ``kernel``²), a 1×1
    ConvBNAct ``conv_out1`` and a 1×1 conv ``conv_out2`` with bias."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int = 5, mid: int = 128,
                 kernel: int = 7):
        super().__init__()
        self.n_convs = n_convs
        cin = in_channels
        for i in range(n_convs):
            setattr(self, f"conv{i}", ConvBNAct(cin, mid, kernel if i else 3, act="relu", **_BN))
            cin = mid
        self.conv_out1 = ConvBNAct(mid, mid, 1, act="relu", **_BN)
        self.conv_out2 = nn.Conv2d(mid, out_channels, 1)

    def forward(self, x):
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i}")(x)
        return self.conv_out2(self.conv_out1(x))


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@MODELS.register(name="OpenPose")
class OpenPose(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None, num_keypoints: int = 18,
                 num_limbs: int = 19, num_stages: int = 3, heatmap_stride: int = 8):
        super().__init__()
        self.num_keypoints, self.num_limbs = num_keypoints, num_limbs
        self.num_stages, self.heatmap_stride = int(num_stages), heatmap_stride
        bb = _cfg_get(model_cfg or {}, "BACKBONE") or {
            "name": "VGG", "subtype": "vgg16_bn", "out_stages": (3,)}
        self.backbone = build_backbone(bb)
        cin = feature_channels(self.backbone)[0]
        self.feat_conv = ConvBNAct(cin, 128, 3, act="relu", **_BN)
        stage_in = 128 + num_keypoints + 1 + 2 * num_limbs
        for t in range(self.num_stages):
            setattr(self, f"hm_stage{t}", PoseStage(128 if t == 0 else stage_in,
                                                    num_keypoints + 1))
            setattr(self, f"paf_stage{t}", PoseStage(128 if t == 0 else stage_in,
                                                     2 * num_limbs))

    def stages(self, images):
        """NHWC images → the lists of every stage's heatmaps and PAFs (NCHW)."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        x = base = self.feat_conv(feats[0])
        hms, pafs = [], []
        for t in range(self.num_stages):
            hm = getattr(self, f"hm_stage{t}")(x)
            paf = getattr(self, f"paf_stage{t}")(x)
            hms.append(hm)
            pafs.append(paf)
            x = torch.cat([base, hm, paf], 1)
        return hms, pafs

    def targets(self, images, targets):
        """The rendered (B, gy, gx, 19) heatmaps and (B, gy, gx, 38) PAFs,
        float32, or the targets' own 'heatmaps'/'pafs'."""
        if "heatmaps" in targets and "pafs" in targets:
            return targets["heatmaps"], targets["pafs"]
        kp = targets["keypoints"]                        # (B, M, 17, 3)
        valid = targets.get("valid")
        if valid is None:
            valid = (kp[..., 2] > 0).any(-1)
        dtype = torch.float64 if kp.dtype == torch.float64 else torch.float32
        with record_function("openpose_targets"), torch.no_grad(), \
                torch.autocast(images.device.type, enabled=False):
            return paf_ops.render_openpose_targets(
                kp.to(dtype), valid.to(dtype), tuple(images.shape[1:3]),
                stride=self.heatmap_stride)

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        hms, pafs = self.stages(images)
        if mode == "infer":
            return {"heatmaps": _nhwc(hms[-1]), "pafs": _nhwc(pafs[-1])}
        t_hm, t_paf = self.targets(images, targets)
        with torch.autocast(images.device.type, enabled=False):
            dtype = t_hm.dtype
            mask = targets.get("mask")
            m = mask[..., None].to(dtype) if mask is not None else 1.0
            hm_loss = sum((((_nhwc(hm).to(dtype) - t_hm) ** 2) * m).mean() for hm in hms)
            paf_loss = sum((((_nhwc(p).to(dtype) - t_paf) ** 2) * m).mean() for p in pafs)
        total = hm_loss + paf_loss
        losses = {"heatmap_loss": hm_loss, "paf_loss": paf_loss, "loss": total}
        if mode == "train":
            return total, losses
        hm, paf = _nhwc(hms[-1]).to(dtype), _nhwc(pafs[-1]).to(dtype)
        xy, score, valid = paf_ops.find_peaks(hm[..., :paf_ops.NUM_JOINTS])
        pair_scores, ok = paf_ops.score_limb_pairs(xy, valid, paf)
        conns = paf_ops.greedy_limb_match(pair_scores, ok)
        B = images.shape[0]
        stride = images.shape[1] // hm.shape[1]
        return losses, {"heatmaps": hm, "pafs": paf, "peaks_xy": xy, "peaks_score": score,
                        "conns": conns,
                        "stride": torch.full((B,), stride, dtype=torch.int32,
                                             device=images.device)}


@MODELS.register(name="SimplePose")
class SimplePose(nn.Module):
    """Deconv-head heatmap pose (SimpleBaseline-style)."""

    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None, num_keypoints: int = 17):
        super().__init__()
        bb = _cfg_get(model_cfg or {}, "BACKBONE") or {
            "name": "ResNet", "subtype": "resnet18", "out_stages": (4,)}
        self.backbone = build_backbone(bb)
        cin = feature_channels(self.backbone)[-1]
        for i in range(3):
            setattr(self, f"deconv{i}", ConvTranspose4x2(cin if i == 0 else 256, 256))
        self.head = nn.Conv2d(256, num_keypoints, 1)

    def heatmaps(self, images):
        """NHWC images → (B, h, w, K) heatmaps."""
        x = self.backbone(images.permute(0, 3, 1, 2))[-1]
        for i in range(3):
            x = F.relu(getattr(self, f"deconv{i}")(x))
        return _nhwc(self.head(x))

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        hm = self.heatmaps(images)
        if mode == "infer":
            return decode_heatmaps(hm)
        t_hm = targets["heatmaps"]
        with torch.autocast(images.device.type, enabled=False):
            hm32 = hm.to(t_hm.dtype)
            valid = targets.get("valid")
            w = valid[:, None, None, :].to(t_hm.dtype) if valid is not None else 1.0
            loss = (((hm32 - t_hm) ** 2) * w).mean()
        losses = {"heatmap_loss": loss, "loss": loss}
        if mode == "train":
            return loss, losses
        return losses, decode_heatmaps(hm32)


@MODELS.register(name="LitePose")
class LitePose(nn.Module):
    """Lite Pose (arXiv:2205.01271): single-branch backbone and a fusion
    deconv head with multi-resolution supervision."""

    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None, num_keypoints: int = 17,
                 deconv_channels: Sequence[int] = (128, 64, 32), num_outputs: int = 2,
                 sigma: float = 2.0):
        super().__init__()
        self.num_keypoints, self.sigma = num_keypoints, sigma
        self.deconv_channels = tuple(deconv_channels)
        self.num_outputs = num_outputs
        bb = _cfg_get(model_cfg or {}, "BACKBONE") or {
            "name": "MobileNetV2", "out_stages": (2, 3, 5, 7), "width_mult": 1.0}
        self.backbone = build_backbone(bb)
        chans = feature_channels(self.backbone)
        n = len(self.deconv_channels)
        cin = chans[-1]
        for i, ch in enumerate(self.deconv_channels):
            setattr(self, f"deconv{i}", ConvTranspose4x2(cin, ch))
            setattr(self, f"deconv_bn{i}", BatchNorm2d(ch, eps=1e-5, momentum=0.1))
            setattr(self, f"lateral{i}", nn.Conv2d(chans[len(chans) - 2 - i], ch, 1))
            setattr(self, f"dw{i}", ConvBNAct(ch, ch, 7, groups=ch, act="relu", **_BN))
            setattr(self, f"pw{i}", ConvBNAct(ch, ch, 1, act="relu", **_BN))
            if i >= n - num_outputs:
                setattr(self, f"final{i}", nn.Conv2d(ch, num_keypoints, 1))
            cin = ch

    def heatmap_pyramid(self, images):
        """NHWC images → the supervised scales' (B, h, w, K) heatmaps,
        coarse to fine."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        x = feats[-1]
        outs = []
        n = len(self.deconv_channels)
        for i in range(n):
            x = F.relu(getattr(self, f"deconv_bn{i}")(getattr(self, f"deconv{i}")(x)))
            skip = feats[len(feats) - 2 - i]
            if x.shape[-2:] != skip.shape[-2:]:
                raise ValueError(
                    f"LitePose fuses a ×2 deconvolution of {tuple(x.shape[-2:])} with a backbone "
                    f"stage of {tuple(skip.shape[-2:])}: the input side must be a multiple of 32, "
                    f"not {tuple(images.shape[1:3])} (the JAX model fails to broadcast there)")
            x = x + getattr(self, f"lateral{i}")(skip)
            x = getattr(self, f"pw{i}")(getattr(self, f"dw{i}")(x))
            if i >= n - self.num_outputs:
                outs.append(_nhwc(getattr(self, f"final{i}")(x)))
        return outs

    def loss(self, hms, targets, images):
        ih = images.shape[1]
        if "keypoints" in targets:
            kp = targets["keypoints"]                    # (B, K, 2|3) image pixels
            if kp.dim() != 3:
                raise ValueError(
                    f"LitePose trains on single-instance keypoints (B, K, 2|3), not "
                    f"{tuple(kp.shape)}: the detection collate's (B, M, K, 3) persons do not "
                    "broadcast against its (B, h, w, K) heatmaps (the JAX model fails there)")
            valid = targets.get("valid")
            if valid is None:
                valid = (kp[..., 2] > 0) if kp.shape[-1] > 2 else \
                    torch.ones(kp.shape[:2], dtype=torch.bool, device=kp.device)
            total = 0.0
            for hm in hms:
                s = ih / hm.shape[1]
                t = render_gaussian_heatmaps(kp[..., :2] / s, valid, hm.shape[1:3], self.sigma)
                total = total + ((hm.to(t.dtype) - t) ** 2).mean()
            return total
        t_hi = targets["heatmaps"]                       # rendered at the top scale
        total = 0.0
        for hm in hms:
            t = t_hi if hm.shape[1:3] == t_hi.shape[1:3] else _nhwc(
                resize_linear(t_hi.permute(0, 3, 1, 2), tuple(hm.shape[1:3])))
            total = total + ((hm.to(t.dtype) - t) ** 2).mean()
        return total

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        hms = self.heatmap_pyramid(images)
        if mode == "infer":
            return decode_heatmaps(hms[-1])
        dtype = torch.float64 if images.dtype == torch.float64 else torch.float32
        with torch.autocast(images.device.type, enabled=False):
            hms = [hm.to(dtype) for hm in hms]
            loss = self.loss(hms, targets, images)
        losses = {"heatmap_loss": loss, "loss": loss}
        if mode == "train":
            return loss, losses
        return losses, decode_heatmaps(hms[-1])
