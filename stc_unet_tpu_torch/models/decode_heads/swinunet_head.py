"""SwinUNet head (≙ ``stc_unet_tpu/models/decode_heads/swinunet_head.py``).

Patch embed → 4 encoder stages (PatchMerging between) → the symmetric
decoder (PatchExpand, skip concatenation and a linear back to the
stage's width) → a 4x final expand → a 1x1 output conv → ``cls_seg``.

Every stage's resolution, and so each window and relative-position bias
table, is fixed by ``img_size`` at construction, as in the reference
fork's torch module; an input of another side raises. (The JAX module
takes the resolution from its input, so its tables are as large as the
window that the input used at init gives.)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..bricks import Conv2d, LayerNorm, Linear
from ..builder import HEADS
from ..utils.swin_core import (FinalPatchExpandX4, PatchEmbed, PatchExpand,
                               PatchMerging, SwinTransformerBlock)
from .decode_head import BaseDecodeHead

EMBED_DIM, DEPTHS, NUM_HEADS = 96, (2, 2, 6, 2), (3, 6, 12, 24)
DROP_PATH_RATE = 0.1


class _Stage(nn.Module):
    """A stage of Swin blocks (the odd ones shifted by half a window),
    then a PatchMerging (encoder, ``resample='down'``) or a PatchExpand
    (decoder, ``'up'``) when asked."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 drop_path: Sequence[float], resample: Optional[str] = None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(
                dim, input_resolution, num_heads, window_size=window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                drop_path=float(drop_path[i]))
            for i in range(depth)])
        if resample == 'down':
            self.downsample = PatchMerging(input_resolution, dim)
        elif resample == 'up':
            self.upsample = PatchExpand(input_resolution, dim)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for block in self.blocks:
            x = block(x, generator)
        for name in ('downsample', 'upsample'):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        return x


class SwinTransformerSys(nn.Module):
    """The symmetric encoder-decoder Swin on ``img_size``² NCHW images;
    returns (B, num_classes, img_size·4/patch_size, ...). SwinUNet's
    widths (embed 96, depths 2-2-6-2, heads 3-6-12-24, MLP ratio 4) and
    rates (dropout 0, stochastic depth 0.1) are the JAX module's
    constants."""

    def __init__(self, img_size: int = 512, patch_size: int = 4,
                 in_channels: int = 3, num_classes: int = 64,
                 window_size: int = 7):
        super().__init__()
        embed_dim, depths, num_heads = EMBED_DIM, DEPTHS, NUM_HEADS
        n = len(depths)
        self.img_size = img_size
        pr = self.patches = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_channels, embed_dim)
        dpr = np.linspace(0, DROP_PATH_RATE, sum(depths))

        def stage(i, dim, resample):
            # the decoder reuses the encoder's stochastic-depth slice
            res = pr // 2 ** i
            return _Stage(dim, (res, res), depths[i], num_heads[i],
                          window_size,
                          dpr[sum(depths[:i]):sum(depths[:i + 1])],
                          resample)

        self.layers = nn.ModuleList([
            stage(i, embed_dim * 2 ** i, 'down' if i < n - 1 else None)
            for i in range(n)])
        self.norm = LayerNorm(embed_dim * 2 ** (n - 1), eps=1e-5)
        deepest = pr // 2 ** (n - 1)
        self.layers_up = nn.ModuleList(
            [PatchExpand((deepest, deepest), embed_dim * 2 ** (n - 1))] +
            [stage(n - 1 - i, embed_dim * 2 ** (n - 1 - i),
                   'up' if i < n - 1 else None) for i in range(1, n)])
        for i in range(1, n):
            dim = embed_dim * 2 ** (n - 1 - i)
            self.add_module(f'concat_back_dim_{i}', Linear(2 * dim, dim))
        self.norm_up = LayerNorm(embed_dim, eps=1e-5)
        self.up = FinalPatchExpandX4((pr, pr), embed_dim)
        self.output = Conv2d(embed_dim, num_classes, 1, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if x.shape[2] != self.img_size or x.shape[3] != self.img_size:
            raise ValueError(
                f'SwinUNet takes {self.img_size}x{self.img_size} images '
                f'(its img_size), got {x.shape[2]}x{x.shape[3]}')
        n = len(self.layers)
        x = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer(x, generator)
        x = self.norm(x)
        for i, layer in enumerate(self.layers_up):
            if i == 0:
                x = layer(x)
                continue
            x = torch.cat([x, skips[n - 1 - i]], -1)
            x = getattr(self, f'concat_back_dim_{i}')(x)
            x = layer(x, generator)
        x = self.up(self.norm_up(x))
        side = 4 * self.patches
        x = x.reshape(x.shape[0], side, side, -1).permute(0, 3, 1, 2)
        return self.output(x)


@HEADS.register_module()
class SwinUNet(BaseDecodeHead):
    """SwinUNet (config ``my_config/SwinUnet.py``: img_size 512, patch 8,
    window 16, out_channel 64) on the raw image, whose channel count the
    segmentor gives as ``feature_channels``; a one-channel image is
    repeated to three. The input's side must be ``img_size``. Stochastic
    depth is 0.1, as the JAX module hard-codes it, its masks from the
    caller's ``torch.Generator``. The config's ``norm_cfg`` is accepted
    and unused: the head has no BN."""

    def __init__(self, img_size: int = 512, patch_size: int = 4,
                 window_size: int = 8, out_channel: int = 21843,
                 zero_head: bool = False, vis: bool = False,
                 feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.swin_unet = SwinTransformerSys(
            img_size=img_size, patch_size=patch_size,
            in_channels=3 if feature_channels == 1 else feature_channels,
            num_classes=out_channel, window_size=window_size)
        self._init_cls_seg(out_channel)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        return self.cls_seg(self.swin_unet(x, generator), generator)
