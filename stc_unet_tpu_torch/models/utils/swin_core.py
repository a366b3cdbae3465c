"""Swin core pieces (≙ ``stc_unet_tpu/models/utils/swin_core.py``), only
what MaxViT uses: the relative-position index and stochastic depth. The
rest of the file comes with SwinUNet."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..bricks import drop_scaled


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
