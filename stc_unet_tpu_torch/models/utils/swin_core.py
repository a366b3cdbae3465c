"""Swin core pieces (≙ ``stc_unet_tpu/models/utils/swin_core.py``): the
relative-position index and stochastic depth, which MaxViT uses too, and
SwinUNet's blocks.

Tokens are (B, L, C) with L = H·W in row-major order, as in JAX. Window
partition and reverse are reshapes and permutes; the shifted-window mask
is computed with numpy from the static resolution at construction and
kept as a buffer; attention is plain batched matmuls over (windows·B,
heads, N, N), as the JAX SwinUNet computes it in einsums (no kernel).
``SwinTransformerBlock(pad_to_window=False)`` is SwinUNet's branch: a map
no larger than the window shrinks the window to the map and drops the
shift. ``pad_to_window=True`` is the Swin backbone's: the window is
kept, the map is zero-padded bottom and right to a window multiple
inside the block and cropped back after attention
(:func:`shifted_window_msa`, which the backbone's blocks share)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bricks import Conv2d, Dropout, LayerNorm, Linear, drop_scaled


def drop_path(x, rate: float, generator: Optional[torch.Generator] = None):
    """Stochastic depth (timm semantics): one keep per row of x's first
    axis, drawn from ``generator``; kept rows are scaled by ``1 / (1 -
    rate)``. The identity at rate 0.

    The scale stays in x's dtype, as the fork's timm ``DropPath`` does. The
    JAX function divides by a numpy float64 rate there, which promotes a
    bf16 x to f32 (ROADMAP.md §3)."""
    if rate == 0.0:
        return x
    return drop_scaled(x, rate, (x.shape[0],) + (1,) * (x.ndim - 1),
                       generator)


class DropPath(nn.Module):
    """:func:`drop_path` in training, the identity in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        return drop_path(x, self.rate, generator)


def relative_position_index(window_size: Tuple[int, int]) -> np.ndarray:
    """The standard Swin relative-position index table (Wh·Ww, Wh·Ww)."""
    wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))  # 2, Wh, Ww
    coords_flat = coords.reshape(2, -1)
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def window_partition(x, window_size: int):
    """(B, H, W, C) → (windows·B, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size, w // window_size,
                  window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                               window_size, c)


def window_reverse(windows, window_size: int, h: int, w: int):
    """(windows·B, ws, ws, C) → (B, H, W, C)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.reshape(b, h // window_size, w // window_size, window_size,
                        window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shifted_window_mask(h: int, w: int, window_size: int,
                        shift_size: int) -> Optional[np.ndarray]:
    """The SW-MSA mask (windows, N, N): -100 between tokens of one window
    that come from different regions of the rolled map, else 0; None
    without a shift."""
    if shift_size == 0:
        return None
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window_size), slice(-window_size, -shift_size),
               slice(-shift_size, None)):
        for ws in (slice(0, -window_size), slice(-window_size, -shift_size),
                   slice(-shift_size, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = np.reshape(
        img_mask.reshape(1, h // window_size, window_size,
                         w // window_size, window_size, 1)
        .transpose(0, 1, 3, 2, 4, 5), (-1, window_size * window_size))
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


_MASKS: Dict[tuple, torch.Tensor] = {}


def window_mask(h: int, w: int, window_size: int, shift_size: int,
                device) -> Optional[torch.Tensor]:
    """:func:`shifted_window_mask` of an (h, w) canvas as a tensor on
    ``device``, made once a shape and device."""
    if shift_size == 0:
        return None
    key = (h, w, window_size, shift_size, torch.device(device))
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(shifted_window_mask(
            h, w, window_size, shift_size)).to(device)
    return _MASKS[key]


def shifted_window_msa(x, h: int, w: int, attn, window_size: int,
                       shift_size: int, mask=None, generator=None):
    """(S)W-MSA on (B, H·W, C) tokens of an h×w map: the map zero-padded
    bottom and right to a window multiple (nothing to pad: no copy),
    rolled by ``-shift_size``, its windows through ``attn`` (a
    :class:`WindowAttention`, with ``mask`` made over the padded canvas:
    the padded tokens are not masked as keys, they attend as zeros),
    reversed, rolled back and cropped to h×w."""
    b, _, c = x.shape
    ws, s = window_size, shift_size
    x = x.reshape(b, h, w, c)
    pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if s > 0:
        x = torch.roll(x, (-s, -s), (1, 2))
    windows = window_partition(x, ws).reshape(-1, ws * ws, c)
    windows = attn(windows, mask, generator)
    x = window_reverse(windows.reshape(-1, ws, ws, c), ws, hp, wp)
    if s > 0:
        x = torch.roll(x, (s, s), (1, 2))
    if pad_b or pad_r:
        x = x[:, :h, :w]
    return x.reshape(b, h * w, c)


def init_bias_table_(table: torch.Tensor, generator: torch.Generator):
    """A relative-position bias table from a normal of std 0.02 cut at 2
    std (flax's ``truncated_normal(0.02)``), drawn on the CPU."""
    table.copy_(nn.init.trunc_normal_(torch.empty(table.shape), std=0.02,
                                      a=-0.04, b=0.04, generator=generator))


class WindowAttention(nn.Module):
    """W-MSA with a relative-position bias table, on (windows·B, N, C):
    ``softmax((q · head_dim^-0.5) kᵀ + bias (+ mask)) v``, then ``proj``,
    with dropout on the attention and the projection where their rates
    are set (SwinUNet's are 0: no dropout module). ``persistent_index``
    keeps the (N, N) ``relative_position_index`` in the state dict, as
    the fork's Swin backbone (mmseg's ``WindowMSA``) does; SwinUNet's is
    a buffer outside it."""

    def __init__(self, dim: int, window_size: Tuple[int, int],
                 num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 persistent_index: bool = False):
        super().__init__()
        wh, ww = window_size
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads))
        index = relative_position_index((wh, ww))
        self.register_buffer('relative_position_index', torch.from_numpy(
            index if persistent_index else index.reshape(-1)).long(),
            persistent=persistent_index)
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        if attn_drop > 0:
            self.attn_drop = Dropout(attn_drop)
        if proj_drop > 0:
            self.proj_drop = Dropout(proj_drop)

    def reset_parameters(self, generator: torch.Generator):
        init_bias_table_(self.relative_position_bias_table, generator)

    def forward(self, x, mask=None, generator=None):
        b_, n, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].reshape(
                n, n, heads).permute(2, 0, 1)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, heads, n, n) + \
                mask.to(attn.dtype)[None, :, None]
            attn = attn.reshape(-1, heads, n, n)
        attn = torch.softmax(attn, -1)
        if hasattr(self, 'attn_drop'):
            attn = self.attn_drop(attn, generator)
        x = self.proj((attn @ v).transpose(1, 2).reshape(b_, n, c))
        if hasattr(self, 'proj_drop'):
            x = self.proj_drop(x, generator)
        return x


class SwinMlp(nn.Module):
    """fc1 → exact GELU → fc2 (SwinUNet's dropout rate is 0)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    """(S)W-MSA and an MLP, pre-LN, with DropPath per sample, on (B, H·W,
    C) tokens of the static ``input_resolution``. Without
    ``pad_to_window`` (SwinUNet) a map no larger than the window shrinks
    the window to the map and drops the shift; with it (the Swin
    backbone, JAX ``swin_core.py:183-215``) the window is kept, and the
    ``norm1`` output is zero-padded to a window multiple, attended with
    the shift mask of the padded canvas and cropped back
    (:func:`shifted_window_msa`)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 pad_to_window: bool = False):
        super().__init__()
        h, w = input_resolution
        if not pad_to_window and min(h, w) <= window_size:
            shift_size, window_size = 0, min(h, w)
        self.input_resolution = (h, w)
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, (window_size, window_size),
                                    num_heads)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path2 = DropPath(drop_path)
        ws = window_size
        mask = shifted_window_mask(h + (ws - h % ws) % ws,
                                   w + (ws - w % ws) % ws, ws, shift_size)
        self.register_buffer('attn_mask', None if mask is None else
                             torch.from_numpy(mask), persistent=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h, w = self.input_resolution
        b, l, c = x.shape
        if l != h * w:
            raise ValueError(f'SwinTransformerBlock: {l} tokens, want '
                             f'{h}x{w}')
        x = x + self.drop_path1(shifted_window_msa(
            self.norm1(x), h, w, self.attn, self.window_size,
            self.shift_size, self.attn_mask), generator)
        return x + self.drop_path2(self.mlp(self.norm2(x)), generator)


class PatchMerging(nn.Module):
    """2x2 token merge → 2C: the concatenation of the (even, even),
    (odd, even), (even, odd) and (odd, odd) rows and columns, LN and a
    bias-free linear."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


def _expand(x, h, w, s):
    """(B, H·W, s·s·C) → (B, sH·sW, C): token (i, j) becomes the s×s block
    at (s·i, s·j), its channels split row by row of the block."""
    b, _, c = x.shape
    x = x.reshape(b, h, w, s, s, c // (s * s))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s * w * s,
                                               c // (s * s))


class PatchExpand(nn.Module):
    """2x token expansion: a bias-free linear to 2C, each token split into
    a 2x2 block of C/2, LN."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.expand = Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2, eps=1e-5)

    def forward(self, x):
        h, w = self.input_resolution
        return self.norm(_expand(self.expand(x), h, w, 2))


class FinalPatchExpandX4(nn.Module):
    """4x final expansion: a bias-free linear to 16C, each token split
    into a 4x4 block of C, LN."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.expand = Linear(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        h, w = self.input_resolution
        return self.norm(_expand(self.expand(x), h, w, 4))


class PatchEmbed(nn.Module):
    """A patch_size-strided conv on an NCHW x → (B, H'·W', embed_dim)
    tokens, then LN."""

    def __init__(self, patch_size: int = 4, in_channels: int = 3,
                 embed_dim: int = 96):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch_size,
                           stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x).permute(0, 2, 3, 1)
        b, h, w, c = x.shape
        return self.norm(x.reshape(b, h * w, c))
