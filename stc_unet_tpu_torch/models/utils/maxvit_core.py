"""MaxViT core blocks (≙ ``stc_unet_tpu/models/utils/maxvit_core.py``),
shared by the MaxViT encoder backbone and the MaxViTDecoder head.

MBConv runs NCHW (``channels_last``) like the port's other convolutions;
the transformer blocks take the NHWC view of the same memory, partition it
into windows or grid cells and run the relative self-attention on (B·cells,
N, C). The quirks of the reference are kept: the attention scale is
``num_heads ** -0.5``, not ``head_dim ** -0.5``; MBConv is norm → 1×1 conv →
depthwise conv (stride 2 when it downscales) → SE → 1×1 projection, with a
maxpool + 1×1 skip when it downscales and a 1×1 channel-matching skip in the
decoder.

Every relative self-attention runs ``ops.window_attention``: on the card
its kernels K3f (forward) and K3b (backward), with the attention dropout
drawn inside them. The JAX model takes its Pallas kernel only on one TPU
device and the einsum chain elsewhere; the port has no switch. Every other
random draw (projection and MLP dropout, stochastic depth, the kernel's
seed) comes from the ``torch.Generator`` handed down from the train step.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops.window_attention import window_attention
from ..bricks import BatchNorm, Conv2d, Dropout, LayerNorm, Linear
from ..remat import checkpoint
from .swin_core import DropPath, init_bias_table_, relative_position_index


def window_partition_nhwc(x, window_size: Tuple[int, int]):
    """(B, H, W, C) → (B·windows, wh, ww, C): contiguous windows."""
    b, h, w, c = x.shape
    wh, ww = window_size
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh, ww, c)


def window_reverse_nhwc(windows, original_size: Tuple[int, int],
                        window_size: Tuple[int, int]):
    h, w = original_size
    wh, ww = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // wh // ww)
    x = windows.reshape(b, h // wh, w // ww, wh, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def grid_partition_nhwc(x, grid_size: Tuple[int, int]):
    """(B, H, W, C) → (B·grids, gh, gw, C): dilated (strided) windows."""
    b, h, w, c = x.shape
    gh, gw = grid_size
    x = x.reshape(b, gh, h // gh, gw, w // gw, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, gh, gw, c)


def grid_reverse_nhwc(grid, original_size: Tuple[int, int],
                      grid_size: Tuple[int, int]):
    h, w = original_size
    gh, gw = grid_size
    c = grid.shape[-1]
    b = grid.shape[0] // (h * w // gh // gw)
    x = grid.reshape(b, h // gh, w // gw, gh, gw, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)


class SqueezeExcite(nn.Module):
    """timm-style SE: pool → reduce conv → relu → expand conv → sigmoid."""

    def __init__(self, channels: int, rd_ratio: float = 0.25):
        super().__init__()
        rd = max(1, int(channels * rd_ratio))
        self.conv_reduce = Conv2d(channels, rd, 1)
        self.conv_expand = Conv2d(rd, channels, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.conv_expand(F.relu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """MBConv on NCHW; DropPath draws one keep per image."""

    def __init__(self, in_channels: int, out_channels: int,
                 downscale: bool = False, drop_path: float = 0.0):
        super().__init__()
        c = in_channels
        self.pre_norm = BatchNorm(c)
        self.conv_pw_exp = Conv2d(c, c, 1)
        self.conv_dw = Conv2d(c, c, 3, stride=2 if downscale else 1,
                              padding=1, groups=c, bias=False)
        self.bn_dw = BatchNorm(c)
        self.conv_pw = Conv2d(c, out_channels, 1, bias=False)
        self.bn_pw = BatchNorm(out_channels)
        self.se = SqueezeExcite(out_channels)
        self.conv_proj = Conv2d(out_channels, out_channels, 1)
        self.drop_path = DropPath(drop_path)
        self.downscale = downscale
        if downscale or in_channels != out_channels:
            # the decoder variant matches channels with a 1x1 conv too
            self.skip_conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.conv_pw_exp(self.pre_norm(x))
        y = F.gelu(self.bn_dw(self.conv_dw(y)))
        y = self.se(self.bn_pw(self.conv_pw(y)))
        y = self.drop_path(self.conv_proj(y), generator)
        skip = F.max_pool2d(x, 2, 2) if self.downscale else x
        if hasattr(self, 'skip_conv'):
            skip = self.skip_conv(skip)
        return y + skip


class RelativeSelfAttention(nn.Module):
    """Relative self-attention on (B·cells, N, C) through
    ``ops.window_attention``.

    q, k and v are the thirds of ``qkv_mapping``'s output, already packed
    head-major, and go to the kernel as views of it. The (H, N, N) bias is
    gathered from the table and laid out as the kernel's (N, H·N)
    ``bias_e``. Attention dropout happens inside the kernel, from a seed
    drawn from the generator; the projection's dropout follows in torch."""

    def __init__(self, in_channels: int, num_heads: int = 32,
                 grid_window_size: Tuple[int, int] = (7, 7),
                 attn_drop: float = 0.0, drop: float = 0.0):
        super().__init__()
        gh, gw = grid_window_size
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.qkv_mapping = Linear(in_channels, 3 * in_channels)
        self.proj = Linear(in_channels, in_channels)
        self.drop = Dropout(drop)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * gh - 1) * (2 * gw - 1), num_heads))
        self.register_buffer('relative_position_index', torch.from_numpy(
            relative_position_index((gh, gw)).reshape(-1)).long(),
            persistent=False)

    def reset_parameters(self, generator: torch.Generator):
        init_bias_table_(self.relative_position_bias_table, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b_, n, c = x.shape
        heads = self.num_heads
        scale = heads ** -0.5  # reference quirk: heads, not head_dim
        qkv = self.qkv_mapping(x)
        # bias_e[n, h*N + m] = table[index[n, m], h]
        bias_e = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, heads).transpose(
                1, 2).reshape(n, heads * n)
        rate = float(self.attn_drop) if self.training else 0.0
        if rate > 0:
            seed = torch.randint(2 ** 62, (1,), generator=generator,
                                 device=x.device)
        else:
            seed = torch.zeros((1,), dtype=torch.int64, device=x.device)
        out = window_attention(qkv[..., :c], qkv[..., c:2 * c],
                               qkv[..., 2 * c:], bias_e, seed, heads, scale,
                               rate)
        return self.drop(self.proj(out), generator)


class _Mlp(nn.Module):
    def __init__(self, in_channels: int, hidden: int, out: int,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_channels, hidden)
        self.fc2 = Linear(hidden, out)
        self.drop = Dropout(drop)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.drop(F.gelu(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


class MaxViTTransformerBlock(nn.Module):
    """Partition → LN → relative attention → reverse, with an MLP, on an
    NHWC x. DropPath acts on the partitioned tensor: one keep per window or
    grid cell, not per image."""

    def __init__(self, in_channels: int, partition: str,
                 num_heads: int = 32,
                 grid_window_size: Tuple[int, int] = (7, 7),
                 attn_drop: float = 0.0, drop: float = 0.0,
                 drop_path: float = 0.0, mlp_ratio: float = 4.0):
        super().__init__()
        if partition not in ('window', 'grid'):
            raise ValueError(f'partition must be window or grid, got '
                             f'{partition!r}')
        self.partition = partition
        self.grid_window_size = tuple(grid_window_size)
        c = in_channels
        self.norm_1 = LayerNorm(c, eps=1e-5)
        self.attention = RelativeSelfAttention(c, num_heads,
                                               self.grid_window_size,
                                               attn_drop, drop)
        self.dp1 = DropPath(drop_path)
        self.norm_2 = LayerNorm(c, eps=1e-5)
        self.mlp = _Mlp(c, int(mlp_ratio * c), c, drop)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, h, w, c = x.shape
        gws = self.grid_window_size
        if self.partition == 'window':
            part, rev = window_partition_nhwc, window_reverse_nhwc
        else:
            part, rev = grid_partition_nhwc, grid_reverse_nhwc
        p = part(x, gws).reshape(-1, gws[0] * gws[1], c)
        p = p + self.dp1(self.attention(self.norm_1(p), generator),
                         generator)
        p = p + self.dp2(self.mlp(self.norm_2(p), generator), generator)
        return rev(p.reshape(-1, gws[0], gws[1], c), (h, w), gws)


class MaxViTBlock(nn.Module):
    """MBConv + window attention + grid attention, on an NCHW x."""

    def __init__(self, in_channels: int, out_channels: int,
                 downscale: bool = False, num_heads: int = 32,
                 grid_window_size: Tuple[int, int] = (7, 7),
                 attn_drop: float = 0.0, drop: float = 0.0,
                 drop_path: float = 0.0, mlp_ratio: float = 4.0):
        super().__init__()
        self.mb_conv = MBConv(in_channels, out_channels, downscale,
                              drop_path)
        args = (num_heads, grid_window_size, attn_drop, drop, drop_path,
                mlp_ratio)
        self.block_transformer = MaxViTTransformerBlock(out_channels,
                                                        'window', *args)
        self.grid_transformer = MaxViTTransformerBlock(out_channels, 'grid',
                                                       *args)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                remat_attn: bool = False):
        """``remat_attn`` (``with_cp='attn'``, in training) recomputes the
        two attention transformers in the backward, each on its own;
        MBConv's activations stay saved."""
        x = self.mb_conv(x, generator).permute(0, 2, 3, 1)     # NHWC view
        if remat_attn and self.training:
            x = checkpoint(self.block_transformer, x, generator)
            x = checkpoint(self.grid_transformer, x, generator)
        else:
            x = self.grid_transformer(self.block_transformer(x, generator),
                                      generator)
        return x.permute(0, 3, 1, 2)


def apply_maxvit_block(block: MaxViTBlock, x, with_cp=False,
                       generator: Optional[torch.Generator] = None):
    """Apply a MaxViTBlock, rematerialising in the backward as ``with_cp``
    says (JAX ``maxvit_core.py:221-240``; ``models/remat.py``):

    - ``False``: no remat;
    - ``True`` / ``'block'``: the whole block, only its input saved;
    - ``'dots'``: the whole block with the results of its plain matrix
      products (qkv, proj, the MLP) saved, JAX's
      ``dots_with_no_batch_dims_saveable``; the rest, K3f among it, is
      recomputed;
    - ``'attn'``: the two attention transformers, each on its own.

    In eval, as in JAX, ``with_cp`` changes nothing."""
    mode = 'block' if with_cp is True else with_cp
    if mode not in (False, None, 'block', 'dots', 'attn'):
        raise ValueError(f"with_cp must be False, True, 'block', 'dots' or "
                         f"'attn', got {with_cp!r}")
    if not mode or not block.training:
        return block(x, generator)
    if mode == 'attn':
        return block(x, generator, remat_attn=True)
    return checkpoint(block, x, generator,
                      policy='dots' if mode == 'dots' else None)


def stage_blocks(depth: int, in_channels: int, out_channels: int,
                 downscale: bool, drop_path: Sequence[float],
                 **kwargs) -> nn.ModuleList:
    """A stage's MaxViTBlocks: the first takes in_channels (and downscales
    when asked), the rest out_channels."""
    return nn.ModuleList([
        MaxViTBlock(in_channels if i == 0 else out_channels, out_channels,
                    downscale=downscale and i == 0,
                    drop_path=float(drop_path[i]), **kwargs)
        for i in range(depth)])
