"""MaxViTDecoder head
(≙ ``stc_unet_tpu/models/decode_heads/maxvit_decoder.py``).

The mirror of the encoder: per stage a deconv 2× upsample to the skip's
width, the skip concatenated in front, then MaxViT blocks; a final
bilinear resize to ``output_size`` and the classifier. NCHW in
``channels_last``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops import resize
from ..bricks import BatchNorm, ConvTranspose2d
from ..builder import HEADS
from ..utils.maxvit_core import apply_maxvit_block, stage_blocks
from .decode_head import BaseDecodeHead


class DeconvModule(nn.Module):
    """ConvTranspose(k=4, s=2) + BN + Mish. The JAX module takes flax's
    ``ConvTranspose`` with VALID padding and crops (k - s) / 2 on each
    side; that is torch's ``ConvTranspose2d(padding=(k - s) / 2)`` with the
    kernel flipped in both spatial axes, which the weight bridge does."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 4, scale_factor: int = 2):
        super().__init__()
        self.deconv = ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=scale_factor,
            padding=(kernel_size - scale_factor) // 2)
        self.norm = BatchNorm(out_channels)

    def forward(self, x):
        y = self.norm(self.deconv(x))
        return y * torch.tanh(F.softplus(y))


class DecoderStage(nn.Module):
    """Upsample x to the skip's width, concatenate [skip, x], MaxViT
    blocks."""

    def __init__(self, depth: int, in_channels: int, skip_channels: int,
                 out_channels: int, num_heads: int,
                 grid_window_size: Tuple[int, int], attn_drop: float,
                 drop: float, drop_path: Sequence[float], mlp_ratio: float,
                 with_cp: Any = False):
        super().__init__()
        self.with_cp = with_cp
        self.upsample = DeconvModule(in_channels, skip_channels)
        self.blocks = stage_blocks(
            depth, 2 * skip_channels, out_channels, False, drop_path,
            num_heads=num_heads, grid_window_size=tuple(grid_window_size),
            attn_drop=attn_drop, drop=drop, mlp_ratio=mlp_ratio)

    def forward(self, skip, x, generator: Optional[torch.Generator] = None):
        x = torch.cat([skip, self.upsample(x)], 1)
        for block in self.blocks:
            x = apply_maxvit_block(block, x, self.with_cp, generator)
        return x


@HEADS.register_module()
class MaxViTDecoder(BaseDecodeHead):
    """MaxViT decoder (config ``my_config/MaxViT-UNet.py``). As in JAX, the
    stages take the backbone's levels deepest first, and ``in_index`` and
    ``input_transform`` default to the reference's hard-coded
    ``(0, 1, 2, 3)`` and ``'multiple_select'``. ``feature_channels``, which
    the segmentor hands every head, is not needed: ``in_channels`` names
    the levels' widths."""

    def __init__(self, depths: Sequence[int] = (2, 2, 2),
                 output_size: Tuple[int, int] = (256, 256),
                 num_heads: int = 32,
                 grid_window_size: Tuple[int, int] = (8, 8),
                 attn_drop: float = 0.0, drop: float = 0.0,
                 drop_path: float = 0.0, mlp_ratio: float = 4.0,
                 with_cp: Any = False, in_index: Any = (0, 1, 2, 3),
                 input_transform: Optional[str] = 'multiple_select',
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        super().__init__(in_index=in_index, input_transform=input_transform,
                         **kwargs)
        chans = list(self.in_channels)
        n = len(chans)
        self.output_size = tuple(output_size)
        dpr = np.linspace(0.0, drop_path, sum(depths))
        self.stages = nn.ModuleList([
            DecoderStage(depth, chans[n - i - 1], chans[n - i - 2],
                         chans[n - i - 2], num_heads, grid_window_size,
                         attn_drop, drop,
                         dpr[sum(depths[:i]):sum(depths[:i + 1])], mlp_ratio,
                         with_cp)
            for i, depth in enumerate(depths)])
        self._init_cls_seg(chans[n - len(depths) - 1])

    def forward(self, inputs, generator=None):
        n = len(self.in_channels)
        x = inputs[-1]
        for i, stage in enumerate(self.stages):
            x = stage(inputs[n - i - 2], x, generator)
        x = resize(x.permute(0, 2, 3, 1), size=self.output_size,
                   mode='bilinear', align_corners=self.align_corners,
                   warning=False).permute(0, 3, 1, 2)
        return self.cls_seg(x, generator)
