"""CARUnet head (≙ ``stc_unet_tpu/models/decode_heads/carunet_head.py``;
reference ``decode_heads/carunet_head.py:12``).

A coordinate-attention residual U-Net on the image itself
(``EncoderDecoderFull``): CADRB or DenseCADRB blocks, each gating its
features by ``MecaBlock`` (channel attention) or, with ``ca=True``, by
``CoordAtt``'s gate (``residual=False``: its strip sums are K1, and the
gate is multiplied in torch ops, so no K2 runs), and an optional
DenseASPP bridge.

The JAX module's choices are kept: the reference's ``attention_blcok*``
modules, which its ``forward`` never calls, get no parameters;
:class:`SKAttention` is ported all the same (and tested); the block's
``ConvBlockDrop`` normalises its *input* channels, then the relu and the
conv; the DenseASPP projection takes ``in + 5·64`` channels. NCHW in
``channels_last``; torch modules need their input widths, which the JAX
modules infer. The keys follow the flax names.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops import resize
from ..bricks import BatchNorm, Conv2d, Dropout, Linear
from ..builder import HEADS
from .decode_head import BaseDecodeHead
from .unet_head import CoordAtt


class ConvBlockDrop(nn.Module):
    """BN over the input channels → [relu] → conv3x3."""

    def __init__(self, in_channels: int, features: int,
                 activate: bool = True):
        super().__init__()
        self.activate = activate
        self.bn = BatchNorm(in_channels)
        self.conv1 = Conv2d(in_channels, features, 3, padding=1)

    def forward(self, x):
        h = self.bn(x)
        return self.conv1(F.relu(h) if self.activate else h)


class MecaBlock(nn.Module):
    """Channel attention over the mean (taken in f32, cast back) and the
    max of each channel, through one shared Linear, then a ``c // ratio``
    bottleneck and a sigmoid: the (N, C, 1, 1) score."""

    def __init__(self, channels: int, ratio: int = 4):
        super().__init__()
        self.shared_conv = Linear(channels, channels, bias=False)
        self.fc1 = Linear(channels, channels // ratio, bias=False)
        self.fc2 = Linear(channels // ratio, channels, bias=False)

    def forward(self, x):
        y_avg = x.float().mean((2, 3)).to(x.dtype)
        y_max = x.amax((2, 3))
        out = self.shared_conv(y_avg) + self.shared_conv(y_max)
        out = self.fc2(F.relu(self.fc1(out)))
        return torch.sigmoid(out)[:, :, None, None]


def _attention(features: int, ca: bool) -> nn.Module:
    return CoordAtt(features, features) if ca else MecaBlock(features)


def _score(module: nn.Module, x):
    """The attention ``module``'s score of x: CoordAtt's gate (no K2) or
    MecaBlock's."""
    if isinstance(module, CoordAtt):
        return module(x, residual=False)
    return module(x)


class CADRB(nn.Module):
    """Channel-attention dense residual block: two ``ConvBlockDrop``s, the
    attention score times their output, concatenated with a 1x1 of the
    input, a 1x1 to ``features`` and, with ``activate``, BN + relu."""

    def __init__(self, in_channels: int, features: int,
                 activate: bool = True, ca: bool = False):
        super().__init__()
        self.activate = activate
        self.conv1_1 = ConvBlockDrop(in_channels, features)
        self.conv1_2 = ConvBlockDrop(features, features)
        self.meca = _attention(features, ca)
        self.block_conv = Conv2d(in_channels, features, 1)
        self.conv_final = Conv2d(2 * features, features, 1)
        if activate:
            self.bn = BatchNorm(features)

    def forward(self, x):
        out = self.conv1_2(self.conv1_1(x))
        out = _score(self.meca, out) * out
        out = self.conv_final(torch.cat([out, self.block_conv(x)], 1))
        return F.relu(self.bn(out)) if self.activate else out


class DenseCADRB(nn.Module):
    """CADRB with a gate after each ``ConvBlockDrop`` and both gated maps
    concatenated with the input's 1x1."""

    def __init__(self, in_channels: int, features: int,
                 activate: bool = True, ca: bool = False):
        super().__init__()
        self.activate = activate
        self.conv1_1 = ConvBlockDrop(in_channels, features)
        self.meca1 = _attention(features, ca)
        self.conv1_2 = ConvBlockDrop(features, features)
        self.meca2 = _attention(features, ca)
        self.block_conv = Conv2d(in_channels, features, 1)
        self.conv_final = Conv2d(3 * features, features, 1)
        if activate:
            self.bn = BatchNorm(features)

    def forward(self, x):
        out1 = self.conv1_1(x)
        out1 = _score(self.meca1, out1) * out1
        out2 = self.conv1_2(out1)
        out2 = _score(self.meca2, out2) * out2
        out = self.conv_final(torch.cat([out1, out2, self.block_conv(x)], 1))
        return F.relu(self.bn(out)) if self.activate else out


class _DenseASPPConv(nn.Module):
    """1x1 reduce → 3x3 dilated, each + BN + relu, then element dropout
    (its mask from the caller's generator)."""

    def __init__(self, in_channels: int, inter: int, out: int, rate: int,
                 drop_rate: float = 0.1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, inter, 1)
        self.bn1 = BatchNorm(inter)
        self.conv2 = Conv2d(inter, out, 3, padding=rate, dilation=rate)
        self.bn2 = BatchNorm(out)
        if drop_rate > 0:
            self.drop = Dropout(drop_rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if hasattr(self, 'drop'):
            x = self.drop(x, generator)
        return x


class DenseASPPBlock(nn.Module):
    """Densely connected ASPP at rates 3, 6, 12, 18 and 24, each branch's
    ``inter2`` channels put before its input, then dropout and a 1x1 from
    ``in + 5·inter2`` channels (the reference hard-wires 64) to
    ``inter2``."""

    RATES = (3, 6, 12, 18, 24)

    def __init__(self, in_channels: int, inter1: int = 256,
                 inter2: int = 64):
        super().__init__()
        width = in_channels
        for rate in self.RATES:
            setattr(self, f'aspp_{rate}',
                    _DenseASPPConv(width, inter1, inter2, rate))
            width += inter2
        self.drop = Dropout(0.1)
        self.proj = Conv2d(width, inter2, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for rate in self.RATES:
            a = getattr(self, f'aspp_{rate}')(x, generator)
            x = torch.cat([a, x], 1)
        return self.proj(self.drop(x, generator))


class SKAttention(nn.Module):
    """Selective-kernel attention: a conv + BN + relu branch a kernel size,
    their sum's channel means through ``fc`` and one ``fcs`` Linear a
    branch, softmax over the branches, and the weighted sum. CARUnet
    creates it in the reference and never calls it; it is here for the
    inventory."""

    def __init__(self, channels: int, kernels: Sequence[int] = (1, 3, 5, 7),
                 reduction: int = 4, L: int = 32):
        super().__init__()
        self.kernels = tuple(kernels)
        d = max(L, channels // reduction)
        for k in self.kernels:
            setattr(self, f'conv{k}',
                    Conv2d(channels, channels, k, padding=k // 2))
            setattr(self, f'bn{k}', BatchNorm(channels))
        self.fc = Linear(channels, d)
        self.fcs = nn.ModuleList(Linear(d, channels) for _ in self.kernels)

    def forward(self, x):
        feats = [F.relu(getattr(self, f'bn{k}')(getattr(self, f'conv{k}')(x)))
                 for k in self.kernels]
        u = sum(feats)
        z = self.fc(u.mean((2, 3)))
        weights = torch.stack([fc(z)[:, :, None, None] for fc in self.fcs])
        weights = torch.softmax(weights, 0)
        return (weights * torch.stack(feats)).sum(0)


class _CarUp(nn.Module):
    """Bilinear ×2 (align_corners=True), concat [skip, up], then a CADRB or
    DenseCADRB."""

    def __init__(self, in_channels: int, features: int, ca: bool = False,
                 dense: bool = False):
        super().__init__()
        block = DenseCADRB if dense else CADRB
        self.conv = block(in_channels, features, ca=ca)

    def forward(self, x1, x2):
        x1 = resize(x1.permute(0, 2, 3, 1), scale_factor=2, mode='bilinear',
                    align_corners=True, warning=False).permute(0, 3, 1, 2)
        return self.conv(torch.cat([x2, x1], 1))


@HEADS.register_module()
class CARUnet(BaseDecodeHead):
    """CARUnet: a 16/32/64/64 encoder of (Dense)CADRBs over max pools, an
    optional DenseASPP bridge, a 32/16/16 decoder of ``_CarUp``s and a 1x1
    ``conv_seg`` to ``final_out_channels``. With ``ca``, each block's gate
    is CoordAtt's, which runs K1 once (``densecadrb``: twice) a block:
    7 (14) launches a forward. ``in_channel`` (the reference's input
    width) is accepted and ignored."""

    def __init__(self, ca: bool = False, denseaspp: bool = False,
                 densecadrb: bool = False, in_channel: int = 3,
                 feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.denseaspp = denseaspp
        block = DenseCADRB if densecadrb else CADRB
        self.cadrb_encoder1 = block(feature_channels, 16, ca=ca)
        self.cadrb_encoder2 = block(16, 32, ca=ca)
        self.cadrb_encoder3 = block(32, 64, ca=ca)
        self.cadrb_encoder4 = block(64, 64, ca=ca)
        if denseaspp:
            self.denseaspp_block = DenseASPPBlock(64)
        self.cadrb_decoder3 = _CarUp(64 + 64, 32, ca, densecadrb)
        self.cadrb_decoder2 = _CarUp(32 + 32, 16, ca, densecadrb)
        self.cadrb_decoder1 = _CarUp(16 + 16, 16, ca, densecadrb)
        self.conv_seg = Conv2d(16, self.final_out_channels, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        e1 = self.cadrb_encoder1(x)
        e2 = self.cadrb_encoder2(F.max_pool2d(e1, 2))
        e3 = self.cadrb_encoder3(F.max_pool2d(e2, 2))
        e4 = self.cadrb_encoder4(F.max_pool2d(e3, 2))
        if self.denseaspp:
            e4 = self.denseaspp_block(e4, generator)
        d3 = self.cadrb_decoder3(e4, e3)
        d2 = self.cadrb_decoder2(d3, e2)
        d1 = self.cadrb_decoder1(d2, e1)
        return self.conv_seg(d1)
