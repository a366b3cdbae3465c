"""PSPHead (≙ ``stc_unet_tpu/models/decode_heads/psp_head.py``).

The pyramid pooling module pools the input into 1, 2, 3 and 6 bins a side
(torch's adaptive bins, which overlap where the count does not divide the
side), maps each to ``channels`` by a 1x1 ``ConvModule`` and resizes it
back (bilinear); the input and the four maps are concatenated and fused
by a 3x3 ``ConvModule`` before the classifier. NCHW; the keys are mmseg's
(``psp_modules.0.1.conv.weight``: each scale a pool then a ConvModule).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from stc_unet_tpu_torch.ops import resize
from ..bricks import ConvModule, adaptive_avg_pool2d
from ..builder import HEADS
from .decode_head import BaseDecodeHead


def resize_nchw(x, size, align_corners, mode='bilinear'):
    """Resize of an NCHW x to ``size`` through the NHWC ``ops.resize``
    (bilinear by default; ``align_corners`` None for nearest)."""
    return resize(x.permute(0, 2, 3, 1), size=tuple(size), mode=mode,
                  align_corners=align_corners,
                  warning=False).permute(0, 3, 1, 2)


class _AdaptivePool(nn.Module):
    """``bricks.adaptive_avg_pool2d`` to ``size`` bins a side."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.size)


class PPM(nn.ModuleList):
    """Pyramid pooling module (JAX ``psp_head.py:15``): per scale an
    adaptive average pool, a 1x1 ``ConvModule``, a resize back."""

    def __init__(self, pool_scales: Sequence[int], in_channels: int,
                 channels: int, conv_cfg=None, norm_cfg=None, act_cfg=None,
                 align_corners: bool = False):
        super().__init__([
            nn.Sequential(_AdaptivePool(scale),
                          ConvModule(in_channels, channels, 1,
                                     conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                                     act_cfg=act_cfg))
            for scale in pool_scales])
        self.align_corners = align_corners

    def forward(self, x):
        return [resize_nchw(m(x), x.shape[2:], self.align_corners)
                for m in self]


@HEADS.register_module()
class PSPHead(BaseDecodeHead):
    """Pyramid scene parsing head (JAX ``psp_head.py:40``)."""

    def __init__(self, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 feature_channels: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(**kwargs)
        assert isinstance(pool_scales, (list, tuple)), \
            f'pool_scales must be a list/tuple, got {pool_scales!r}'
        self.pool_scales = tuple(pool_scales)
        c_in = self._input_channels(feature_channels)
        self.psp_modules = PPM(self.pool_scales, c_in, self.channels,
                               self.conv_cfg, self.norm_cfg, self.act_cfg,
                               self.align_corners)
        self.bottleneck = ConvModule(
            c_in + len(self.pool_scales) * self.channels, self.channels, 3,
            padding=1, conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
            act_cfg=self.act_cfg)
        self._init_cls_seg(self.channels)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        feats = self.bottleneck(torch.cat([x] + self.psp_modules(x), 1))
        return self.cls_seg(feats, generator)
