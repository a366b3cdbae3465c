"""UPerHead (≙ ``stc_unet_tpu/models/decode_heads/uper_head.py``): the
pyramid pooling module on the deepest level and an FPN's top-down fusion
over all levels.

The PPM of ``psp_head.py`` on the last level, concatenated with it and
fused by a 3x3 ``bottleneck``; a 1x1 ``lateral_convs.{i}`` on each other
level; from the top down, each lateral plus the one above resized to its
size (bilinear); a 3x3 ``fpn_convs.{i}`` on each but the top; every
level resized to the first one's size, concatenated and fused by a 3x3
``fpn_bottleneck``; the classifier. NCHW; the keys are mmseg's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..bricks import ConvModule
from ..builder import HEADS
from .decode_head import BaseDecodeHead
from .psp_head import PPM, resize_nchw


@HEADS.register_module()
class UPerHead(BaseDecodeHead):
    """Unified Perceptual Parsing head (JAX ``uper_head.py:18``), over the
    levels of ``in_index`` (``input_transform='multiple_select'``)."""

    def __init__(self, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        kwargs.setdefault('in_index', (0, 1, 2, 3))
        kwargs.setdefault('input_transform', 'multiple_select')
        super().__init__(**kwargs)
        widths = self._level_widths(feature_channels)
        cfg = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                   act_cfg=self.act_cfg)
        ch = self.channels
        self.psp_modules = PPM(pool_scales, widths[-1], ch,
                               align_corners=self.align_corners, **cfg)
        self.bottleneck = ConvModule(widths[-1] + len(pool_scales) * ch, ch,
                                     3, padding=1, **cfg)
        self.lateral_convs = nn.ModuleList([
            ConvModule(c, ch, 1, **cfg) for c in widths[:-1]])
        self.fpn_convs = nn.ModuleList([
            ConvModule(ch, ch, 3, padding=1, **cfg) for _ in widths[:-1]])
        self.fpn_bottleneck = ConvModule(len(widths) * ch, ch, 3, padding=1,
                                         **cfg)
        self._init_cls_seg(ch)

    def forward(self, inputs, generator=None):
        inputs = self._transform_inputs(inputs)
        x = inputs[-1]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, inputs)]
        laterals.append(self.bottleneck(torch.cat([x] + self.psp_modules(x),
                                                  1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nchw(
                laterals[i], laterals[i - 1].shape[2:], self.align_corners)
        outs = [conv(f) for conv, f in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        size = outs[0].shape[2:]
        outs = [outs[0]] + [resize_nchw(f, size, self.align_corners)
                            for f in outs[1:]]
        return self.cls_seg(self.fpn_bottleneck(torch.cat(outs, 1)),
                            generator)
