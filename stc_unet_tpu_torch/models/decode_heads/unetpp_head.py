"""UNet++ head (≙ ``stc_unet_tpu/models/decode_heads/unetpp_head.py``).

A VGG16-BN conv encoder (widths fixed at 64 to 512, biased convs) and the
nested dense-skip UNet++ decoder (bias-free convs), then a 3x3
``final_conv`` to ``head_classes`` and ``cls_seg``. NCHW in
``channels_last``; module names follow the flax ones (``s2_conv1``,
``x_1_2``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops import resize
from ..bricks import BatchNorm, Conv2d
from ..builder import HEADS
from .decode_head import BaseDecodeHead

VGG16_CFG = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
             (512, 512, 512))


class VGG16Encoder(nn.Module):
    """5 stages of conv3x3-BN-relu, a 2x2 maxpool before each but the
    first; returns the 5 stages' outputs (64 at /1 to 512 at /16)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        c = in_channels
        for si, stage in enumerate(VGG16_CFG):
            for ci, ch in enumerate(stage):
                self.add_module(f's{si}_conv{ci}', Conv2d(c, ch, 3,
                                                         padding=1))
                self.add_module(f's{si}_bn{ci}', BatchNorm(ch))
                c = ch

    def forward(self, x):
        feats = []
        for si, stage in enumerate(VGG16_CFG):
            if si > 0:
                x = F.max_pool2d(x, 2)
            for ci in range(len(stage)):
                x = getattr(self, f's{si}_conv{ci}')(x)
                x = F.relu(getattr(self, f's{si}_bn{ci}')(x))
            feats.append(x)
        return feats


class UppBlock(nn.Module):
    """(conv3x3 without bias → BN → relu) × 2 on the concatenated skips."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv0 = Conv2d(in_channels, out_channels, 3, padding=1,
                            bias=False)
        self.bn0 = BatchNorm(out_channels)
        self.conv1 = Conv2d(out_channels, out_channels, 3, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(out_channels)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


@HEADS.register_module()
class UnetPlusPlus(BaseDecodeHead):
    """Nested UNet++ over the VGG16 encoder (config ``my_config/UNet++.py``)
    on the raw image, whose channel count the segmentor gives as
    ``feature_channels``. Node ``x_i_j`` (row i at scale /2^i, column j)
    takes row i's columns 0 to j-1 and then node ``x_{i+1}_{j-1}``
    resized bilinearly (``align_corners=False``) to row i's size.
    ``deep_supervision`` is accepted and unused, as in JAX."""

    def __init__(self, deep_supervision: bool = False,
                 head_classes: int = 64,
                 decoder_row_channels: Sequence[int] = (16, 32, 64, 128),
                 feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.encoder = VGG16Encoder(feature_channels)
        levels = len(VGG16_CFG)
        rc = list(decoder_row_channels)
        width = {(i, 0): VGG16_CFG[i][-1] for i in range(levels)}
        for j in range(1, levels):
            for i in range(levels - j):
                cin = sum(width[(i, k)] for k in range(j)) + \
                    width[(i + 1, j - 1)]
                self.add_module(f'x_{i}_{j}', UppBlock(cin, rc[i]))
                width[(i, j)] = rc[i]
        self.final_conv = Conv2d(rc[0], head_classes, 3, padding=1)
        self._init_cls_seg(head_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feats = self.encoder(x)
        levels = len(feats)
        grid = {(i, 0): feats[i] for i in range(levels)}
        for j in range(1, levels):
            for i in range(levels - j):
                up = resize(grid[(i + 1, j - 1)].permute(0, 2, 3, 1),
                            size=grid[(i, 0)].shape[2:], mode='bilinear',
                            align_corners=False,
                            warning=False).permute(0, 3, 1, 2)
                cat = torch.cat([grid[(i, k)] for k in range(j)] + [up], 1)
                grid[(i, j)] = getattr(self, f'x_{i}_{j}')(cat)
        return self.cls_seg(self.final_conv(grid[(0, levels - 1)]),
                            generator)
