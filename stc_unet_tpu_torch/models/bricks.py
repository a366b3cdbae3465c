"""Neural building blocks for the port (NCHW ``nn.Module``s).

Counterpart of ``stc_unet_tpu/models/bricks.py``, only what the STC-UNet
path uses. Parameters are stored f32 with torch's names (``weight``,
``bias``, ``running_mean``, ...), so ``state_dict`` keys are the reference
fork's. The dtype rules are the JAX package's:

- ``Conv2d`` and ``Linear`` cast their f32 weights to ``x.dtype`` at use,
  as ``nn.Conv``/``nn.Dense(dtype=x.dtype)`` do;
- ``BatchNorm`` computes in f32 and casts back to ``x.dtype``, in the
  order of the JAX brick.

Pooling, padding and channel dropout are torch's own (``nn.MaxPool2d``,
``F.pad``, ``nn.Dropout2d``): they already have the JAX bricks' torch
semantics. Only eval mode exists in this slice: ``BatchNorm`` raises in
training mode.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_TRAINING = ('training mode is not ported yet: it belongs to the training '
             'slice (ROADMAP.md, Slice B)')


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
    """BatchNorm2d, eval only: ``(f32(x) - mean) * rsqrt(var + eps) *
    weight + bias``, cast back to ``x.dtype`` (JAX ``bricks.py:133-135``)."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(f'BatchNorm: {_TRAINING}')
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * \
            inv[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
