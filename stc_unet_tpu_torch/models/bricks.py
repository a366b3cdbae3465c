"""Neural building blocks for the port (NCHW ``nn.Module``s).

Counterpart of ``stc_unet_tpu/models/bricks.py``, only what the STC-UNet
path uses. Parameters are stored f32 with torch's names (``weight``,
``bias``, ``running_mean``, ...), so ``state_dict`` keys are the reference
fork's. The dtype rules are the JAX package's:

- ``Conv2d`` and ``Linear`` cast their f32 weights to ``x.dtype`` at use,
  as ``nn.Conv``/``nn.Dense(dtype=x.dtype)`` do;
- ``BatchNorm`` computes in f32 and casts back to ``x.dtype``, in the
  order of the JAX brick, in training mode too.

Pooling and padding are torch's own (``nn.MaxPool2d``, ``F.pad``): they
already have the JAX bricks' torch semantics. ``Dropout2d`` draws its
mask from a ``torch.Generator`` the caller hands in, as the JAX brick
draws it from the ``dropout`` rng.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def h_sigmoid(x):
    """ReLU6(x + 3) / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x):
    """x * h_sigmoid(x)."""
    return x * h_sigmoid(x)


class Conv2d(nn.Conv2d):
    """torch Conv2d whose f32 weights are cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """torch Linear whose f32 weights are cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d in the JAX brick's formula (``bricks.py:113-135``):
    ``(f32(x) - mean) * rsqrt(var + eps) * weight + bias``, cast back to
    ``x.dtype``.

    In training the statistics are the batch's, over (N, H, W) in f32:
    ``mean = E[x]`` and the biased ``var = E[x²] - mean²``, with the
    gradient flowing through both. The running stats take the unbiased
    variance ``var·n/(n-1)`` at torch's momentum convention, ``r = (1-m)·r
    + m·batch``, and ``num_batches_tracked`` counts as in torch. In eval
    the running stats are used.
    """

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = xf.square().mean((0, 2, 3)) - mean.square()
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean +
                                        m * mean)
                self.running_var.copy_((1 - m) * self.running_var +
                                       m * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * inv[:, None, None] + \
            self.bias[:, None, None]
        return y.to(x.dtype)


class Dropout2d(nn.Module):
    """Channel dropout (JAX ``bricks.py:442-449``): in training, one keep
    mask per (n, c), kept channels scaled by ``1 / (1 - p)``. The mask is
    drawn from ``generator`` (a ``torch.Generator`` on x's device), or
    from torch's default one when it is None. The identity in eval."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
