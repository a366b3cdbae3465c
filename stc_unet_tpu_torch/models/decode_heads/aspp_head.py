"""ASPPHead (≙ ``stc_unet_tpu/models/decode_heads/aspp_head.py``).

The image-pool branch (the mean over the map, a 1x1 ``ConvModule``,
resized back) and one branch a dilation (a 1x1 ``ConvModule`` for
dilation 1, a 3x3 one dilated otherwise; a
``DepthwiseSeparableConvModule`` in the separable head) are concatenated
and fused by a 3x3 ``ConvModule`` before the classifier. NCHW; the keys
are mmseg's (``image_pool.1.conv.weight``, ``aspp_modules.1.conv``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..bricks import ConvModule, DepthwiseSeparableConvModule
from ..builder import HEADS
from .decode_head import BaseDecodeHead
from .psp_head import resize_nchw


class ASPPModule(nn.ModuleList):
    """Parallel atrous branches (JAX ``aspp_head.py:15``)."""

    def __init__(self, dilations: Sequence[int], in_channels: int,
                 channels: int, conv_cfg=None, norm_cfg=None, act_cfg=None,
                 separable: bool = False):
        branches = []
        for dilation in dilations:
            k, pad = (1, 0) if dilation == 1 else (3, dilation)
            if separable and k != 1:
                branches.append(DepthwiseSeparableConvModule(
                    in_channels, channels, k, padding=pad, dilation=dilation,
                    norm_cfg=norm_cfg, act_cfg=act_cfg))
            else:
                branches.append(ConvModule(
                    in_channels, channels, k, padding=pad, dilation=dilation,
                    conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg))
        super().__init__(branches)

    def forward(self, x):
        return [branch(x) for branch in self]


class _ImagePool(nn.Module):
    """The mean over the map, one pixel a channel; a bf16 x is averaged
    in f32, as ``jnp.mean`` does."""

    def forward(self, x):
        return x.float().mean((2, 3), keepdim=True).to(x.dtype)


@HEADS.register_module()
class ASPPHead(BaseDecodeHead):
    """Atrous spatial pyramid pooling head (JAX ``aspp_head.py:45``)."""

    separable = False

    def __init__(self, dilations: Sequence[int] = (1, 6, 12, 18),
                 feature_channels: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(**kwargs)
        assert isinstance(dilations, (list, tuple)), \
            'dilations must be a list/tuple'
        self.dilations = tuple(dilations)
        c_in = self._input_channels(feature_channels)
        cfgs = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        self.image_pool = nn.Sequential(
            _ImagePool(), ConvModule(c_in, self.channels, 1, **cfgs))
        self.aspp_modules = ASPPModule(self.dilations, c_in, self.channels,
                                       separable=self.separable, **cfgs)
        self.bottleneck = ConvModule(
            (len(self.dilations) + 1) * self.channels, self.channels, 3,
            padding=1, **cfgs)
        self._init_cls_seg(self.channels)

    def _aspp(self, x):
        pooled = resize_nchw(self.image_pool(x), x.shape[2:],
                             self.align_corners)
        return torch.cat([pooled] + self.aspp_modules(x), 1)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        return self.cls_seg(self.bottleneck(self._aspp(x)), generator)
