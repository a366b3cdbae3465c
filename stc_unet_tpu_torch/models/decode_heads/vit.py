"""ViT for TransUNet (≙ ``stc_unet_tpu/models/decode_heads/vit.py``).

The JAX module's quirks are kept: the packed ``qkv_layer`` splits as
``(b, t, head_dim, 3, heads)`` (einops' ``(d k h)``); the attention
scores are *multiplied* by sqrt(head_dim); exact GELU; post-LN blocks;
the patch factor is the slow axis of each side; a ``cls_token``, and a
learned position ``embedding`` sized by ``img_dim`` and sliced to the
tokens + 1, so a smaller input still runs. Dropout is 0.1 throughout, as
the JAX module hard-codes it; its masks come from the caller's
``torch.Generator``. Sequences are (B, T, C).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bricks import Dropout, LayerNorm, Linear

DROPOUT = 0.1


class MultiHeadAttention(nn.Module):
    def __init__(self, embedding_dim: int, head_num: int):
        super().__init__()
        self.head_num = head_num
        self.qkv_layer = Linear(embedding_dim, embedding_dim * 3, bias=False)
        self.out_attention = Linear(embedding_dim, embedding_dim, bias=False)

    def forward(self, x):
        b, t, c = x.shape
        hd = c // self.head_num
        qkv = self.qkv_layer(x).reshape(b, t, hd, 3, self.head_num)
        q, k, v = (qkv[:, :, :, i].permute(0, 3, 1, 2) for i in range(3))
        energy = q @ k.transpose(-1, -2) * hd ** 0.5   # multiplied (quirk)
        out = torch.softmax(energy, -1) @ v
        return self.out_attention(out.transpose(1, 2).reshape(b, t, c))


class MLP(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = Linear(embedding_dim, mlp_dim)
        self.fc2 = Linear(mlp_dim, embedding_dim)
        self.dropout = Dropout(DROPOUT)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.dropout(F.gelu(self.fc1(x)), generator)
        return self.dropout(self.fc2(x), generator)


class TransformerEncoderBlock(nn.Module):
    """Post-LN: attention → dropout → add → LN, MLP → add → LN."""

    def __init__(self, embedding_dim: int, head_num: int, mlp_dim: int):
        super().__init__()
        self.multi_head_attention = MultiHeadAttention(embedding_dim,
                                                       head_num)
        self.dropout = Dropout(DROPOUT)
        self.layer_norm1 = LayerNorm(embedding_dim, eps=1e-5)
        self.mlp = MLP(embedding_dim, mlp_dim)
        self.layer_norm2 = LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        a = self.dropout(self.multi_head_attention(x), generator)
        x = self.layer_norm1(x + a)
        return self.layer_norm2(x + self.mlp(x, generator))


class ViT(nn.Module):
    """Patchify → project → cls token + position embedding → blocks, on an
    NHWC x; returns the (B, T, C) tokens without the cls token (TransUNet's
    use: the JAX module's classification head is not ported)."""

    def __init__(self, img_dim: int, in_channels: int, embedding_dim: int,
                 head_num: int, mlp_dim: int, block_num: int,
                 patch_dim: int = 1):
        super().__init__()
        self.patch_dim = patch_dim
        self.projection = Linear(patch_dim * patch_dim * in_channels,
                                 embedding_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embedding_dim))
        self.embedding = nn.Parameter(torch.zeros(
            (img_dim // patch_dim) ** 2 + 1, embedding_dim))
        self.dropout = Dropout(DROPOUT)
        self.layer_blocks = nn.ModuleList([
            TransformerEncoderBlock(embedding_dim, head_num, mlp_dim)
            for _ in range(block_num)])

    def reset_parameters(self, generator: torch.Generator):
        """``cls_token`` from a standard normal, ``embedding`` uniform in
        [0, 1) (flax's ``normal(1.0)`` and ``uniform(1.0)``)."""
        self.cls_token.copy_(torch.randn(self.cls_token.shape,
                                         generator=generator))
        self.embedding.copy_(torch.rand(self.embedding.shape,
                                        generator=generator))

    def patchify(self, x):
        """(B, H, W, C) → (B, H/p · W/p, p·p·C). The patch factor is the
        slow axis of each side: H splits into p bands of H/p rows, and
        token (i, j) takes row i of every band (and column j of every band
        of W), not the p×p block at (p·i, p·j)."""
        p = self.patch_dim
        b, h, w, c = x.shape
        return x.reshape(b, p, h // p, p, w // p, c).permute(
            0, 2, 4, 1, 3, 5).reshape(b, (h // p) * (w // p), p * p * c)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b = x.shape[0]
        patches = self.patchify(x)
        tokens = patches.shape[1]
        project = self.projection(patches)
        token = self.cls_token.to(x.dtype).expand(b, 1, -1)
        xs = torch.cat([token, project], 1) + \
            self.embedding[:tokens + 1].to(x.dtype)
        xs = self.dropout(xs, generator)
        for block in self.layer_blocks:
            xs = block(xs, generator)
        return xs[:, 1:]
