"""JPU neck, FastFCN's joint pyramid upsampling
(≙ ``stc_unet_tpu/models/necks/jpu.py``).

Each level of ``[start_level, end_level)`` through a 3x3 ``ConvModule``
to ``mid_channels`` (``conv_layers.{i}.0``), resized to the first one's
size (bilinear, ``align_corners``) and concatenated; then one
``DepthwiseSeparableConvModule`` a dilation (``dilation_layers.{i}.0``,
no activation after the depthwise conv), concatenated into the fused
map. BN and ReLU where the cfgs are None. Returns
``inputs[start_level:end_level - 1]`` and the fused map. NCHW; the keys
are mmseg's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..bricks import ConvModule, DepthwiseSeparableConvModule
from ..builder import NECKS
from ..decode_heads.psp_head import resize_nchw
from .fpn import check_widths


@NECKS.register_module()
class JPU(nn.Module):
    """Joint pyramid upsampling (JAX ``jpu.py:16``)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 mid_channels: int = 512, start_level: int = 0,
                 end_level: int = -1, dilations: Sequence[int] = (1, 2, 4, 8),
                 align_corners: bool = False,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 feature_channels: Optional[Sequence[int]] = None):
        super().__init__()
        # the JAX module's checks (jpu.py:30-40)
        assert isinstance(in_channels, (list, tuple)), \
            'in_channels must be a tuple'
        assert isinstance(dilations, (list, tuple)), \
            'dilations must be a tuple'
        if end_level != -1:
            assert end_level <= len(in_channels), \
                f'end_level {end_level} exceeds the number of input ' \
                f'levels ({len(in_channels)})'
        widths = check_widths(in_channels, feature_channels)
        self.num_ins = len(widths)
        self.start = start_level
        self.end = len(widths) if end_level == -1 else end_level
        self.align_corners = align_corners
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        used = widths[self.start:self.end]
        self.conv_layers = nn.ModuleList([
            nn.Sequential(ConvModule(c, mid_channels, 3, padding=1,
                                     conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                                     act_cfg=act_cfg)) for c in used])
        self.dilation_layers = nn.ModuleList([
            nn.Sequential(DepthwiseSeparableConvModule(
                len(used) * mid_channels, mid_channels, 3, padding=d,
                dilation=d, norm_cfg=norm_cfg, act_cfg=act_cfg,
                dw_act_cfg=None)) for d in dilations])
        self.out_channels = widths[self.start:self.end - 1] + \
            [len(dilations) * mid_channels]

    def forward(self, inputs):
        assert len(inputs) == self.num_ins
        feats = [conv(x) for conv, x in
                 zip(self.conv_layers, inputs[self.start:self.end])]
        size = feats[0].shape[2:]
        feat = torch.cat([feats[0]] + [
            resize_nchw(f, size, self.align_corners)
            for f in feats[1:]], 1)
        fused = torch.cat([layer(feat) for layer in self.dilation_layers], 1)
        return list(inputs[self.start:self.end - 1]) + [fused]
