"""DepthwiseSeparableASPPHead, DeepLabV3+'s head
(≙ ``stc_unet_tpu/models/decode_heads/sep_aspp_head.py``).

``ASPPHead`` with separable dilated branches; its fused map is resized to
the first backbone level, concatenated with that level through a 1x1
``ConvModule`` (``c1_bottleneck``, when ``c1_in_channels`` > 0) and
refined by two 3x3 ``DepthwiseSeparableConvModule``s (``sep_bottleneck``)
before the classifier.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..bricks import ConvModule, DepthwiseSeparableConvModule
from ..builder import HEADS
from .aspp_head import ASPPHead
from .psp_head import resize_nchw


@HEADS.register_module()
class DepthwiseSeparableASPPHead(ASPPHead):
    """ASPP with separable convs and the c1 skip (JAX
    ``sep_aspp_head.py:17``). The skip's width is the first backbone
    level's where the segmentor gives ``feature_channels`` (JAX infers
    it), else ``c1_in_channels``."""

    separable = True

    def __init__(self, c1_in_channels: int = 0, c1_channels: int = 48,
                 feature_channels: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(feature_channels=feature_channels, **kwargs)
        self.c1_in_channels = c1_in_channels
        width = self.channels
        if c1_in_channels > 0:
            c1 = c1_in_channels if feature_channels is None \
                else feature_channels[0]
            self.c1_bottleneck = ConvModule(
                c1, c1_channels, 1, conv_cfg=self.conv_cfg,
                norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
            width += c1_channels
        self.sep_bottleneck = nn.Sequential(
            DepthwiseSeparableConvModule(width, self.channels, 3, padding=1,
                                         norm_cfg=self.norm_cfg,
                                         act_cfg=self.act_cfg),
            DepthwiseSeparableConvModule(self.channels, self.channels, 3,
                                         padding=1, norm_cfg=self.norm_cfg,
                                         act_cfg=self.act_cfg))

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        output = self.bottleneck(self._aspp(x))
        if self.c1_in_channels > 0:
            c1 = self.c1_bottleneck(inputs[0])
            output = torch.cat([resize_nchw(output, c1.shape[2:],
                                            self.align_corners), c1], 1)
        return self.cls_seg(self.sep_bottleneck(output), generator)
