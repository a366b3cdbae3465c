"""Neural building blocks for the port (NCHW ``nn.Module``s).

Counterpart of ``stc_unet_tpu/models/bricks.py``, only what the ported
models use. Parameters are stored f32 with torch's names (``weight``,
``bias``, ``running_mean``, ...), so ``state_dict`` keys are the reference
fork's. The dtype rules are the JAX package's:

- ``Conv2d``, ``ConvTranspose2d`` and ``Linear`` cast their f32 weights to
  ``x.dtype`` at use, as ``nn.Conv``/``nn.ConvTranspose``/
  ``nn.Dense(dtype=x.dtype)`` do;
- ``LayerNorm`` normalises in f32 and casts back to ``x.dtype``, as flax's
  ``nn.LayerNorm(dtype=x.dtype)`` does;
- ``BatchNorm`` computes in f32 and casts back to ``x.dtype``, in the
  order of the JAX brick, in training mode too.

Pooling and padding are torch's own (``nn.MaxPool2d``, ``F.pad``): they
already have the JAX bricks' torch semantics. ``Dropout`` and
``Dropout2d`` draw their masks from a ``torch.Generator`` the caller hands
in, as the JAX modules draw them from the ``dropout`` rng.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.utils.util_distribution import all_reduce_sum
from .remat import recomputing


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


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ConvTranspose2d whose f32 weights are cast to the input's
    dtype. Its weight (in, out, kh, kw) is the flax kernel (kh, kw, in, out)
    flipped in both spatial axes (``utils/jax_convert.py``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, computed in f32 and cast back to
    ``x.dtype`` (flax ``nn.LayerNorm(dtype=x.dtype)``; its default eps here
    is the JAX modules' 1e-5)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


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

    With ``affine=False`` (DC-UNet's BN after a relu or sigmoid conv)
    there is no weight or bias: the JAX brick's scale of ones and bias of
    zeros.

    With a ``process_group`` of more than one rank (set by
    ``engine.make_train_step`` from its data mesh) the batch is the global
    one, as under the JAX mesh step (the reference's SyncBN): the f32 sums
    of x and x² and the element count go through one differentiable
    all-reduce (a (2C+1,) vector), and ``mean``, ``var`` and ``n`` are
    the global ones, so every rank takes the same running stats.

    Under ``models.remat.checkpoint`` the recomputed forward takes the
    batch's moments again but leaves the running stats and
    ``num_batches_tracked`` as the first forward left them.
    """

    process_group = None

    def forward(self, x):
        xf = x.float()
        if self.training:
            n = x.numel() // x.shape[1]
            if self.process_group is None:
                mean = xf.mean((0, 2, 3))
                var = xf.square().mean((0, 2, 3)) - mean.square()
                bessel = n / max(n - 1, 1)
            else:
                c = x.shape[1]
                sums = all_reduce_sum(torch.cat([
                    xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)),
                    xf.new_full((1,), n)]), self.process_group)
                n = sums[2 * c]
                mean = sums[:c] / n
                var = sums[c:2 * c] / n - mean.square()
                bessel = n / (n - 1).clamp(min=1)
            if not recomputing():
                self._update_running_stats(mean, var, bessel)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        if self.affine:
            inv = inv * self.weight
        y = (xf - mean[:, None, None]) * inv[:, None, None]
        if self.affine:
            y = y + self.bias[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running_stats(self, mean, var, bessel):
        """torch's momentum update, with the unbiased variance."""
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var +
                               m * (var * bessel))
        self.num_batches_tracked.add_(1)


def drop_scaled(x, rate: float, shape, generator=None):
    """x with entries dropped at ``rate`` and the kept ones scaled by
    ``1 / (1 - rate)``, in x's dtype; one keep per element of ``shape``
    (broadcast over x), drawn from ``generator``."""
    keep = 1.0 - float(rate)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


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
        return drop_scaled(x, self.p, (x.shape[0], x.shape[1], 1, 1),
                           generator)


class Dropout(nn.Module):
    """Element dropout (flax ``nn.Dropout``): in training, each element is
    kept with ``1 - p`` and scaled by ``1 / (1 - p)``; the mask is drawn
    from ``generator`` (a ``torch.Generator`` on x's device), or from
    torch's default one when it is None. The identity in eval."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0:
            return x
        return drop_scaled(x, self.p, x.shape, generator)


# ---------------------------------------------------------------------------
# the mmcv-style bricks of the ResNet models (JAX ``bricks.py:56-431``)
# ---------------------------------------------------------------------------

def _identity(x):
    return x


_ACTIVATIONS = {
    'ReLU': F.relu,
    'ReLU6': lambda x: torch.clamp(x, 0.0, 6.0),
    'SiLU': F.silu,
    'Swish': F.silu,
    'Sigmoid': torch.sigmoid,
    'Tanh': torch.tanh,
    'GELU': F.gelu,          # exact, as the JAX brick asks flax for
    'HSwish': h_swish,
    'HSigmoid': h_sigmoid,
    'Identity': _identity,
}


def build_activation_layer(act_cfg: Optional[dict]):
    """The activation *function* of an mmcv-style ``act_cfg`` (JAX
    ``bricks.py:56``): None is the identity, ``LeakyReLU`` takes its
    ``negative_slope`` (0.01). ``PReLU`` has parameters: ``ConvModule``
    makes it a module; here it raises, as in JAX."""
    if act_cfg is None:
        return _identity
    cfg = dict(act_cfg)
    act_type = cfg.pop('type')
    if act_type == 'LeakyReLU':
        slope = cfg.get('negative_slope', 0.01)
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise KeyError(f'Unsupported activation type: {act_type}')
    return fn


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW channels, computed in f32; the result stays
    f32, as flax's ``nn.GroupNorm`` with f32 parameters promotes it."""

    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


class ChannelLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` on NHWC: each pixel's C channels normalised,
    here on an NCHW x, in f32; the result stays f32 (flax promotes it with
    its f32 parameters)."""

    def forward(self, x):
        return F.layer_norm(x.float().permute(0, 2, 3, 1),
                            self.normalized_shape, self.weight, self.bias,
                            self.eps).permute(0, 3, 1, 2)


class InstanceNorm(nn.Module):
    """Instance norm without parameters (flax ``nn.GroupNorm`` with a group
    a channel and no scale or bias), computed in f32, cast back."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return F.group_norm(x.float(), x.shape[1], eps=self.eps).to(x.dtype)


def build_norm_layer(norm_cfg: Optional[dict], num_features: int):
    """``(name, module)`` for an mmcv-style ``norm_cfg`` over
    ``num_features`` channels (JAX ``bricks.py:138``): ``BN``/``SyncBN``
    (``bn``, the port's ``BatchNorm``, its global-batch moments under a
    data mesh being the reference's SyncBN), ``GN`` (``gn``), ``LN``
    (``ln``, over the channels) and ``IN`` (``in``); ``(None, None)`` for
    None. ``requires_grad`` is dropped, as in JAX.

    JAX's ``_apply_norm`` (:177) passes ``train`` to a BN only; here every
    module follows its own ``training`` flag, so there is nothing to
    port."""
    if norm_cfg is None:
        return None, None
    cfg = dict(norm_cfg)
    norm_type = cfg.pop('type')
    cfg.pop('requires_grad', None)
    eps = cfg.pop('eps', 1e-5)
    if norm_type in ('BN', 'SyncBN', 'BN2d', 'BN1d'):
        return 'bn', BatchNorm(num_features, eps=eps,
                               momentum=cfg.pop('momentum', 0.1))
    if norm_type == 'GN':
        return 'gn', GroupNorm(cfg.pop('num_groups'), num_features, eps=eps)
    if norm_type == 'LN':
        return 'ln', ChannelLayerNorm(num_features, eps=eps)
    if norm_type == 'IN':
        return 'in', InstanceNorm(eps)
    raise KeyError(f'Unsupported norm type: {norm_type}')


class PReLU(nn.Module):
    """torch ``nn.PReLU(num_parameters=C)`` in the JAX brick's formula
    ``max(x, 0) + weight·min(x, 0)``, the slope 0.25 at init."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), 0.25))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x):
        a = self.weight.to(x.dtype)[:, None, None]
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


class ConvModule(nn.Module):
    """Conv + norm + activation (mmcv ``ConvModule``, JAX
    ``bricks.py:275``): the conv is ``conv``, the norm takes its name from
    ``build_norm_layer`` (``bn``), a PReLU is ``activate``, so the keys
    are the reference's (``bottleneck.conv.weight``,
    ``bottleneck.bn.running_mean``). ``bias='auto'`` gives the conv a
    bias only without a norm; ``order`` is any order of ``'conv'``,
    ``'norm'`` and ``'act'``. The defaults are the JAX brick's
    (``act_cfg=None``); ``conv_cfg`` is accepted and ignored, as there."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, padding=0, dilation=1,
                 groups: int = 1, bias='auto',
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 order=('conv', 'norm', 'act')):
        super().__init__()
        self.order = tuple(order)
        if sorted(self.order) != ['act', 'conv', 'norm']:
            raise ValueError(f'order must hold conv, norm and act once, got '
                             f'{order}')
        use_bias = (norm_cfg is None) if bias == 'auto' else bool(bias)
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation, groups, bias=use_bias)
        conv_at = self.order.index('conv')

        def width(op):
            return out_channels if self.order.index(op) > conv_at \
                else in_channels

        self.norm_name, norm = build_norm_layer(norm_cfg, width('norm'))
        if norm is not None:
            self.add_module(self.norm_name, norm)
        self.act = None       # the activation function (a PReLU: activate)
        if act_cfg and act_cfg.get('type') == 'PReLU':
            self.activate = PReLU(width('act'))
        elif act_cfg:
            self.act = build_activation_layer(act_cfg)

    def forward(self, x):
        for op in self.order:
            if op == 'conv':
                x = self.conv(x)
            elif op == 'norm' and self.norm_name is not None:
                x = getattr(self, self.norm_name)(x)
            elif op == 'act' and hasattr(self, 'activate'):
                x = self.activate(x)
            elif op == 'act' and self.act is not None:
                x = self.act(x)
        return x


class DepthwiseSeparableConvModule(nn.Module):
    """A depthwise ``ConvModule`` (``depthwise_conv``, a group a channel)
    then a 1x1 one (``pointwise_conv``), each with its norm and activation
    (JAX ``bricks.py:319``): ``dw_*``/``pw_*`` of ``'default'`` take
    ``norm_cfg``/``act_cfg``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=0, dilation=1,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, dw_norm_cfg='default',
                 dw_act_cfg='default', pw_norm_cfg='default',
                 pw_act_cfg='default'):
        super().__init__()

        def pick(own, common):
            return common if own == 'default' else own

        self.depthwise_conv = ConvModule(
            in_channels, in_channels, kernel_size, stride, padding, dilation,
            groups=in_channels, norm_cfg=pick(dw_norm_cfg, norm_cfg),
            act_cfg=pick(dw_act_cfg, act_cfg))
        self.pointwise_conv = ConvModule(
            in_channels, out_channels, 1,
            norm_cfg=pick(pw_norm_cfg, norm_cfg),
            act_cfg=pick(pw_act_cfg, act_cfg))

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


def avg_pool2d(x, kernel_size=2, stride=None, padding=0,
               count_include_pad: bool = True):
    """torch ``AvgPool2d`` on NCHW (JAX ``bricks.py:369`` gives its
    semantics on NHWC)."""
    return F.avg_pool2d(x, kernel_size, kernel_size if stride is None
                        else stride, padding,
                        count_include_pad=count_include_pad)


def adaptive_avg_pool2d(x, output_size):
    """torch ``AdaptiveAvgPool2d`` on NCHW (JAX ``bricks.py:387``): bin i
    of n over a side of s spans ``[floor(i·s/n), ceil((i+1)·s/n))``, so
    bins overlap where n does not divide s; a None side is kept. A bf16 x
    is averaged in f32 and cast back, as in JAX."""
    if x.dtype == torch.bfloat16:
        return F.adaptive_avg_pool2d(x.float(), output_size).to(x.dtype)
    return F.adaptive_avg_pool2d(x, output_size)


def adaptive_max_pool2d(x, output_size):
    """The largest value of each channel (JAX ``bricks.py:431``), NCHW;
    as there, only a 1x1 output."""
    size = tuple(output_size) if isinstance(output_size, (tuple, list)) \
        else (output_size, output_size)
    size = tuple(x.shape[2 + i] if s is None else s
                 for i, s in enumerate(size))
    if size != (1, 1):
        raise NotImplementedError(
            'adaptive_max_pool2d only supports output 1x1')
    return x.amax((2, 3), keepdim=True)
