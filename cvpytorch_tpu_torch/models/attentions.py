"""Plug-in attention blocks (counterpart of ``cvpytorch_tpu/models/attentions.py``),
NCHW, each scaling its input: SE with a bias-free Linear MLP, cSE, sSE,
scSE, SimAM (no parameters), CBAM's channel and spatial gates and CBAM
itself, and ECA.  Submodules carry the Flax tree's names, so
``utils/porting.load_jax_variables`` carries a JAX block's weights; the
port's constructors take the input channels, which Flax reads off the
input.
"""
from __future__ import annotations

import torch
from torch import nn


class SEAttention(nn.Module):
    """Squeeze-and-excitation: global mean → ``fc1`` (C // reduction, no
    bias) → ReLU → ``fc2`` (C, no bias) → sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x):
        y = self.fc2(torch.relu(self.fc1(x.mean((2, 3)))))
        return x * torch.sigmoid(y)[:, :, None, None]


class cSEBlock(nn.Module):
    """Channel SE with bias-free 1×1 convolutions."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        y = self.fc2(torch.relu(self.fc1(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(y)


class sSEBlock(nn.Module):
    """Spatial SE: a 1×1 convolution to one channel gates each pixel."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, 1, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.conv(x))


class scSEBlock(nn.Module):
    """cSE + sSE, summed (arXiv:1803.02579)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.cSE = cSEBlock(channels, reduction)
        self.sSE = sSEBlock(channels)

    def forward(self, x):
        return self.cSE(x) + self.sSE(x)


class SimAM(nn.Module):
    """Parameter-free attention (Yang et al., ICML 2021)."""

    def __init__(self, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x):
        n = x.shape[2] * x.shape[3] - 1
        d = torch.square(x - x.mean((2, 3), keepdim=True))
        y = d / (4 * (d.sum((2, 3), keepdim=True) / n + self.e_lambda)) + 0.5
        return x * torch.sigmoid(y)


class ChannelAttentionModule(nn.Module):
    """CBAM's channel gate: one MLP (``fc1``, ``fc2``, with biases) over
    the average- and max-pooled descriptors → the (B, C, 1, 1) gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x):
        def mlp(v):
            return self.fc2(torch.relu(self.fc1(v)))
        return torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))[:, :, None, None]


class SpatialAttentionModule(nn.Module):
    """CBAM's spatial gate: a 7×7 convolution over the channel mean and
    max → the (B, 1, H, W) gate."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        y = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv(y))


class CBAM(nn.Module):
    """Convolutional block attention (arXiv:1807.06521): the channel gate,
    then the spatial gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.channel_attention = ChannelAttentionModule(channels, reduction)
        self.spatial_attention = SpatialAttentionModule()

    def forward(self, x):
        x = self.channel_attention(x) * x
        return self.spatial_attention(x) * x


class ECAAttention(nn.Module):
    """Efficient channel attention (arXiv:1910.03151): a 1-D convolution
    (with bias) along the channel descriptor."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x):
        y = self.conv(x.mean((2, 3))[:, None, :])  # (B, 1, C): channels as length
        return x * torch.sigmoid(y[:, 0])[:, :, None, None]


__all__ = ["SEAttention", "cSEBlock", "sSEBlock", "scSEBlock", "SimAM",
           "ChannelAttentionModule", "SpatialAttentionModule", "CBAM", "ECAAttention"]
