"""SwinTransformer backbone (≙ ``stc_unet_tpu/models/backbones/swin.py``).

The modules are laid out as the reference fork's (mmseg v0.29.1
``backbones/swin.py``), so the ``state_dict`` keys are a fork ``.pth``'s:
``patch_embed.projection``, ``patch_embed.norm``,
``stages.{i}.blocks.{j}.norm1``, ``.attn.w_msa.{qkv,proj,
relative_position_bias_table}`` and the ``relative_position_index``
buffer, ``norm2``, ``ffn.layers.0.0``, ``ffn.layers.1``,
``stages.{i}.downsample.{norm,reduction}`` and ``norm{i}``.

Tokens are (B, H·W, C), row-major. The image is padded bottom and right
to a patch multiple, embedded by a strided conv and a LayerNorm; every
block pads its map to a window multiple inside
(``swin_core.shifted_window_msa``), so the window never shrinks; an odd
map is padded to even before each ``PatchMerging``. Stage shapes come
from the input, so any H×W works. Each stage of ``out_indices`` ends in
an eps-1e-5 LayerNorm ``norm{i}``, and its features are returned NCHW
(a view of the channels-last tokens).

The fork's ``PatchMerging`` concatenates each 2×2 block channel-major,
the positions (0, 0), (0, 1), (1, 0), (1, 1) within a channel
(``nn.Unfold``'s order); the JAX one takes the official concatenation
(x00, x10, x01, x11), channel-minor. The port follows the fork, and the
weight bridge (``utils/jax_convert.py``) permutes the merge's 4C axis
(ROADMAP.md §3, kept on purpose).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

from ..bricks import Conv2d, Dropout, LayerNorm, Linear
from ..builder import BACKBONES
from ..utils.swin_core import (DropPath, WindowAttention, shifted_window_msa,
                               window_mask)

_ITEM_20 = 'is not ported yet (ROADMAP.md §1, item 20)'


class PatchEmbed(nn.Module):
    """NCHW image → (B, H'·W', C) tokens and (H', W'): padded bottom and
    right to a patch multiple, a ``patch_size``-strided conv
    (``projection``), a LayerNorm (``norm``, with ``patch_norm``)."""

    def __init__(self, in_channels: int, embed_dims: int, patch_size: int,
                 patch_norm: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.projection = Conv2d(in_channels, embed_dims, patch_size,
                                 stride=patch_size)
        if patch_norm:
            self.norm = LayerNorm(embed_dims, eps=1e-5)

    def forward(self, x):
        ps = self.patch_size
        pad_h, pad_w = (ps - x.shape[2] % ps) % ps, (ps - x.shape[3] % ps) % ps
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h))
        x = self.projection(x).permute(0, 2, 3, 1)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        if hasattr(self, 'norm'):
            x = self.norm(x)
        return x, (h, w)


class PatchMerging(nn.Module):
    """2×2 token merge → ``out_channels``: an odd map padded to even
    (bottom, right), each 2×2 block concatenated channel-major in
    ``nn.Unfold``'s order (channel c's (0, 0), (0, 1), (1, 0), (1, 1) at
    4c to 4c + 3), LayerNorm, a bias-free linear."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_channels, eps=1e-5)
        self.reduction = Linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x, hw_shape):
        (h, w), (b, _, c) = hw_shape, x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(
            b, h2 * w2, 4 * c)
        return self.reduction(self.norm(x)), (h2, w2)


class ShiftWindowMSA(nn.Module):
    """(S)W-MSA of a block (``w_msa``, the window attention) on padded
    windows, then the block's first DropPath (``drop``)."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 shift_size: int, qkv_bias: bool, attn_drop_rate: float,
                 proj_drop_rate: float, drop_path_rate: float):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.w_msa = WindowAttention(
            embed_dims, (window_size, window_size), num_heads, qkv_bias,
            attn_drop_rate, proj_drop_rate, persistent_index=True)
        self.drop = DropPath(drop_path_rate)

    def forward(self, x, hw_shape, generator=None):
        (h, w), ws = hw_shape, self.window_size
        mask = window_mask(h + (ws - h % ws) % ws, w + (ws - w % ws) % ws,
                           ws, self.shift_size, x.device)
        return self.drop(shifted_window_msa(
            x, h, w, self.w_msa, ws, self.shift_size, mask, generator),
            generator)


class FFN(nn.Module):
    """fc1 → exact GELU → dropout → fc2 → dropout (``layers``), then the
    block's second DropPath (``dropout_layer``) and the identity added
    (mmcv's ``FFN``)."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 ffn_drop: float, drop_path_rate: float):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dims, feedforward_channels),
                          nn.GELU(), Dropout(ffn_drop)),
            Linear(feedforward_channels, embed_dims), Dropout(ffn_drop))
        self.dropout_layer = DropPath(drop_path_rate)

    def forward(self, x, identity, generator=None):
        fc1, act, drop1 = self.layers[0]
        x = drop1(act(fc1(x)), generator)
        x = self.layers[2](self.layers[1](x), generator)
        return identity + self.dropout_layer(x, generator)


class SwinBlock(nn.Module):
    """Pre-LN (S)W-MSA and FFN, each with its residual."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, window_size: int, shift: bool,
                 qkv_bias: bool, drop_rate: float, attn_drop_rate: float,
                 drop_path_rate: float):
        super().__init__()
        self.norm1 = LayerNorm(embed_dims, eps=1e-5)
        self.attn = ShiftWindowMSA(
            embed_dims, num_heads, window_size,
            window_size // 2 if shift else 0, qkv_bias, attn_drop_rate,
            drop_rate, drop_path_rate)
        self.norm2 = LayerNorm(embed_dims, eps=1e-5)
        self.ffn = FFN(embed_dims, feedforward_channels, drop_rate,
                       drop_path_rate)

    def forward(self, x, hw_shape, generator=None):
        x = x + self.attn(self.norm1(x), hw_shape, generator)
        return self.ffn(self.norm2(x), x, generator)


class SwinBlockSequence(nn.Module):
    """A stage: ``depth`` blocks, the odd ones shifted by half a window,
    then the ``downsample`` merge (all stages but the last). Returns the
    next stage's tokens and shape, and this stage's output and shape."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, depth: int, window_size: int,
                 qkv_bias: bool, drop_rate: float, attn_drop_rate: float,
                 drop_path_rates: Sequence[float],
                 downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(embed_dims, num_heads, feedforward_channels,
                      window_size, i % 2 == 1, qkv_bias, drop_rate,
                      attn_drop_rate, float(drop_path_rates[i]))
            for i in range(depth)])
        self.downsample = downsample

    def forward(self, x, hw_shape, generator=None):
        for block in self.blocks:
            x = block(x, hw_shape, generator)
        if self.downsample is None:
            return x, hw_shape, x, hw_shape
        down, down_hw = self.downsample(x, hw_shape)
        return down, down_hw, x, hw_shape


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin backbone in mmseg's vocabulary (JAX ``swin.py:61``); returns
    the NCHW features of ``out_indices`` (strides 4, 8, 16, 32), whose
    widths ``out_channels`` lists.

    As in JAX: ``drop_path_rate`` rises linearly over all blocks,
    ``drop_rate`` drops after the patch embed, in the attention's
    projection and in the FFN, ``attn_drop_rate`` on the attention,
    ``with_cp`` is accepted and changes nothing. Where the JAX module
    accepts a field and ignores it, and the fork's module does not, the
    port refuses it: ``use_abs_pos_embed`` (the fork adds a learned
    embedding, JAX none: ROADMAP.md §3), a ``qk_scale``, an ``act_cfg``
    other than GELU or a ``norm_cfg`` other than LN, and
    ``frozen_stages``. A ``pretrained`` path or a ``Pretrained``
    ``init_cfg`` raises too: no weights are loaded from them (item 20)."""

    def __init__(self, pretrain_img_size=224, in_channels: int = 3,
                 embed_dims: int = 96, patch_size: int = 4,
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 patch_norm: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 use_abs_pos_embed: bool = False,
                 act_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, with_cp: bool = False,
                 pretrained: Optional[str] = None, frozen_stages: int = -1,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # the JAX module's construction-time checks (swin.py:89-105)
        if pretrained is not None:
            assert init_cfg is None, \
                'init_cfg and pretrained cannot be specified at the same time'
            if not isinstance(pretrained, str):
                raise TypeError('pretrained must be a str path or None, '
                                f'got {type(pretrained).__name__}')
        assert strides[0] == patch_size, \
            'Use non-overlapping patch embed: strides[0] must equal ' \
            f'patch_size, got {strides[0]} vs {patch_size}'
        if isinstance(pretrain_img_size, (tuple, list)):
            assert len(pretrain_img_size) <= 2, \
                f'pretrain_img_size tuple length must be <= 2, ' \
                f'got {pretrain_img_size}'
        elif not isinstance(pretrain_img_size, int):
            raise TypeError('pretrain_img_size must be an int or a tuple')
        if pretrained is not None or (isinstance(init_cfg, dict) and
                                      init_cfg.get('type') == 'Pretrained'):
            raise NotImplementedError(f'a pretrained backbone {_ITEM_20}')
        if use_abs_pos_embed:
            raise NotImplementedError(
                'use_abs_pos_embed=True: the fork adds a learned position '
                'embedding and the JAX module ignores the field, so the '
                'port has no result to match (ROADMAP.md §3)')
        if qk_scale is not None:
            raise NotImplementedError('qk_scale: the JAX module ignores it')
        if (act_cfg or {}).get('type', 'GELU') != 'GELU' or \
                (norm_cfg or {}).get('type', 'LN') != 'LN':
            raise NotImplementedError(
                f'act_cfg {act_cfg} / norm_cfg {norm_cfg}: the JAX module '
                'takes GELU and LayerNorm whatever they say')
        if frozen_stages >= 0:
            raise NotImplementedError(f'frozen_stages {_ITEM_20}')
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size,
                                      patch_norm)
        self.drop_after_pos = Dropout(drop_rate)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.stages = nn.ModuleList()
        dims = [int(embed_dims * 2 ** i) for i in range(len(depths))]
        for i, depth in enumerate(depths):
            last = i == len(depths) - 1
            self.stages.append(SwinBlockSequence(
                dims[i], num_heads[i], int(mlp_ratio * dims[i]), depth,
                window_size, qkv_bias, drop_rate, attn_drop_rate,
                dpr[sum(depths[:i]):sum(depths[:i + 1])],
                None if last else PatchMerging(dims[i], 2 * dims[i])))
        for i in self.out_indices:
            self.add_module(f'norm{i}', LayerNorm(dims[i], eps=1e-5))
        self.out_channels = [dims[i] for i in self.out_indices]

    def forward(self, x, generator=None):
        x, hw = self.patch_embed(x)
        x = self.drop_after_pos(x, generator)
        outs = []
        for i, stage in enumerate(self.stages):
            x, next_hw, out, hw = stage(x, hw, generator)
            if i in self.out_indices:
                out = getattr(self, f'norm{i}')(out)
                outs.append(out.reshape(out.shape[0], hw[0], hw[1],
                                        -1).permute(0, 3, 1, 2))
            hw = next_hw
        return outs
