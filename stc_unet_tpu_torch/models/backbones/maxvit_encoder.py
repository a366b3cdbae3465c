"""MaxViT encoder backbone
(≙ ``stc_unet_tpu/models/backbones/maxvit_encoder.py``).

A conv stem (stride 2), then 4 stages whose first block downscales, so the
features come out at strides 4/8/16/32 with the configured channels. NCHW
in ``channels_last``; the module names mirror the flax names, with their
sequence suffixes as indices (``stem.0``, ``stages.1.blocks.0``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..bricks import Conv2d
from ..builder import BACKBONES
from ..utils.maxvit_core import apply_maxvit_block, stage_blocks


class MaxViTStage(nn.Module):
    """An encoder stage: ``depth`` MaxViTBlocks, the first downscaling."""

    def __init__(self, depth: int, in_channels: int, out_channels: int,
                 num_heads: int, grid_window_size: Tuple[int, int],
                 attn_drop: float, drop: float, drop_path: Sequence[float],
                 mlp_ratio: float, with_cp: Any = False):
        super().__init__()
        self.with_cp = with_cp
        self.blocks = stage_blocks(
            depth, in_channels, out_channels, True, drop_path,
            num_heads=num_heads, grid_window_size=tuple(grid_window_size),
            attn_drop=attn_drop, drop=drop, mlp_ratio=mlp_ratio)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for block in self.blocks:
            x = apply_maxvit_block(block, x, self.with_cp, generator)
        return x


@BACKBONES.register_module()
class MaxViT(nn.Module):
    """MaxViT backbone (config: ``my_config/MaxViT-UNet.py``). The
    drop-path rates rise linearly from 0 to ``drop_path`` over all blocks;
    ``num_classes`` is accepted for config parity and ignored (no
    classification head)."""

    def __init__(self, in_channels: int = 3,
                 depths: Sequence[int] = (2, 2, 5, 2),
                 channels: Sequence[int] = (64, 128, 256, 512),
                 embed_dim: int = 64, num_heads: int = 32,
                 grid_window_size: Tuple[int, int] = (7, 7),
                 attn_drop: float = 0.0, drop: float = 0.0,
                 drop_path: float = 0.0, mlp_ratio: float = 4.0,
                 num_classes: int = 1000, with_cp: Any = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.stem = nn.Sequential(
            Conv2d(in_channels, embed_dim, 3, 2, padding=1), nn.GELU(),
            Conv2d(embed_dim, embed_dim, 3, 1, padding=1), nn.GELU())
        dpr = np.linspace(0.0, drop_path, sum(depths))
        ins = [embed_dim] + list(channels[:-1])
        self.stages = nn.ModuleList([
            MaxViTStage(depth, ins[i], ch, num_heads, grid_window_size,
                        attn_drop, drop,
                        dpr[sum(depths[:i]):sum(depths[:i + 1])], mlp_ratio,
                        with_cp)
            for i, (depth, ch) in enumerate(zip(depths, channels))])
        self.out_channels = list(channels)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.stem(x)
        outs = []
        for stage in self.stages:
            x = stage(x, generator)
            outs.append(x)
        return outs
