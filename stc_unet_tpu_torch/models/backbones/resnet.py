"""ResNet, ResNetV1c and ResNetV1d backbones
(≙ ``stc_unet_tpu/models/backbones/resnet.py``).

The mmseg dialect the configs use (``my_config/PSPNet.py``,
``my_config/DeepLabv3+.py``): ``depth`` 18/34/50/101/152, ``strides`` and
``dilations`` a stage (output stride 8 with strides (1, 2, 1, 1) and
dilations (1, 1, 2, 4)), ``contract_dilation`` (the first block of a
dilated stage takes half the dilation), ``multi_grid`` (the last stage's
blocks take these dilations), ``style`` (``'pytorch'``: the stride on a
bottleneck's 3x3 conv, ``'caffe'``: on its first 1x1), ``deep_stem``
(three 3x3 convs, V1c and V1d) and ``avg_down`` (an average pool before
the downsample's 1x1 conv, V1d), ``out_indices``.

NCHW in ``channels_last``. The modules are laid out as mmseg's, so the
``state_dict`` keys are the reference's: ``conv1``/``bn1`` or ``stem.0``
to ``stem.7``, ``layer1.0.conv1.weight``, ``layer1.0.bn1.running_mean``,
``layer1.0.downsample.0.weight`` (``downsample.1`` and ``.2`` under
``avg_down``, behind the pool).

Beyond JAX, whose functional design carries no ``requires_grad``:
``norm_eval`` keeps every BN in eval while the model trains, and
``frozen_stages`` k keeps the stem and the first k stages in eval with
their parameters frozen, as mmseg's ``train()`` does. As in JAX,
``zero_init_residual`` and ``with_cp`` are accepted and change nothing
(the seeded init gives every BN a scale of one), and ``conv_cfg`` and
``norm_cfg`` are accepted with BN the only norm. ``dcn``, ``plugins``
and a ``pretrained`` path are not ported (ROADMAP.md, item 20).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..bricks import BatchNorm, Conv2d
from ..builder import BACKBONES

_ITEM_20 = 'is not ported yet (ROADMAP.md, item 20)'


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: Optional[nn.Module] = None,
                 style: str = 'pytorch'):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 residual block (expansion 4)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: Optional[nn.Module] = None,
                 style: str = 'pytorch'):
        super().__init__()
        s1, s2 = (1, stride) if style == 'pytorch' else (stride, 1)
        self.conv1 = Conv2d(inplanes, planes, 1, s1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, s2, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = BatchNorm(planes * self.expansion)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def downsample(inplanes: int, out_channels: int, stride: int,
               avg_down: bool) -> nn.Sequential:
    """The shortcut of a block that changes the shape (JAX ``_Downsample``,
    mmseg ``ResLayer``): a strided 1x1 conv and a BN; with ``avg_down`` an
    average pool of the stride (the last partial window kept, averaged over
    its valid pixels) and an unstrided conv."""
    layers = []
    if avg_down:
        layers.append(nn.AvgPool2d(stride, stride, ceil_mode=True,
                                   count_include_pad=False))
        stride = 1
    layers += [Conv2d(inplanes, out_channels, 1, stride, bias=False),
               BatchNorm(out_channels)]
    return nn.Sequential(*layers)


class ResLayer(nn.Sequential):
    """A stage of residual blocks (mmseg ``ResLayer``): the first takes the
    stride and, where the shape changes, the downsample; the dilations are
    ``multi_grid``'s when given (one a block), else the stage's, halved for
    the first block under ``contract_dilation``."""

    def __init__(self, block, inplanes: int, planes: int, num_blocks: int,
                 stride: int = 1, dilation: int = 1, style: str = 'pytorch',
                 avg_down: bool = False, contract_dilation: bool = False,
                 multi_grid: Optional[Sequence[int]] = None):
        out = planes * block.expansion
        ds = None
        if stride != 1 or inplanes != out:
            ds = downsample(inplanes, out, stride, avg_down)
        if multi_grid is not None:
            dilations = list(multi_grid)
            if len(dilations) != num_blocks:
                raise ValueError(f'multi_grid has {len(dilations)} '
                                 f'dilations for {num_blocks} blocks')
        else:
            first = dilation // 2 if dilation > 1 and contract_dilation \
                else dilation
            dilations = [first] + [dilation] * (num_blocks - 1)
        blocks = [block(inplanes, planes, stride, dilations[0], ds, style)]
        blocks += [block(out, planes, 1, d, None, style)
                   for d in dilations[1:]]
        super().__init__(*blocks)


@BACKBONES.register_module()
class ResNet(nn.Module):
    """ResNet backbone (JAX ``backbones/resnet.py:165``). ``forward``
    returns the features of ``out_indices``; ``out_channels`` lists their
    widths."""

    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }
    deep_stem_default = False
    avg_down_default = False

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = 'pytorch', deep_stem: Optional[bool] = None,
                 avg_down: Optional[bool] = None, frozen_stages: int = -1,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None, norm_eval: bool = False,
                 dcn: Optional[dict] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 plugins: Optional[list] = None,
                 multi_grid: Optional[Sequence[int]] = None,
                 contract_dilation: bool = False, with_cp: bool = False,
                 zero_init_residual: bool = True,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # the JAX module's construction-time checks (resnet.py:201-222)
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for {type(self).__name__}')
        assert 1 <= num_stages <= 4, \
            f'num_stages must be in [1, 4], got {num_stages}'
        assert len(strides) == len(dilations) == num_stages, \
            (f'strides ({len(strides)}) and dilations ({len(dilations)}) '
             f'must match num_stages ({num_stages})')
        assert style in ('pytorch', 'caffe'), \
            f"style must be 'pytorch' or 'caffe', got {style!r}"
        if pretrained is not None and not isinstance(pretrained, str):
            raise TypeError('pretrained must be a str path or None, '
                            f'got {type(pretrained).__name__}')
        if pretrained is not None:
            raise NotImplementedError(f'a pretrained backbone {_ITEM_20}')
        if dcn is not None or any(stage_with_dcn):
            raise NotImplementedError(f'dcn {_ITEM_20}')
        if plugins:
            raise NotImplementedError(f'plugins {_ITEM_20}')
        self.deep_stem = self.deep_stem_default if deep_stem is None \
            else deep_stem
        self.avg_down = self.avg_down_default if avg_down is None \
            else avg_down
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        block, stage_blocks = self.arch_settings[depth]
        if self.deep_stem:
            mid = stem_channels // 2
            self.stem = nn.Sequential(
                Conv2d(in_channels, mid, 3, 2, padding=1, bias=False),
                BatchNorm(mid), nn.ReLU(),
                Conv2d(mid, mid, 3, 1, padding=1, bias=False),
                BatchNorm(mid), nn.ReLU(),
                Conv2d(mid, stem_channels, 3, 1, padding=1, bias=False),
                BatchNorm(stem_channels), nn.ReLU())
        else:
            self.conv1 = Conv2d(in_channels, stem_channels, 7, 2, padding=3,
                                bias=False)
            self.bn1 = BatchNorm(stem_channels)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        self.res_layers = []
        inplanes = stem_channels
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = base_channels * 2 ** i
            layer = ResLayer(
                block, inplanes, planes, num_blocks, stride=strides[i],
                dilation=dilations[i], style=style, avg_down=self.avg_down,
                contract_dilation=contract_dilation,
                multi_grid=multi_grid if i == num_stages - 1 else None)
            self.add_module(f'layer{i + 1}', layer)
            self.res_layers.append(f'layer{i + 1}')
            inplanes = planes * block.expansion
        self.out_channels = [base_channels * 2 ** i * block.expansion
                             for i in self.out_indices]

        self._freeze_stages()

    def _freeze_stages(self):
        """The stem and the first ``frozen_stages`` stages in eval, their
        parameters frozen (mmseg ``ResNet._freeze_stages``)."""
        if self.frozen_stages < 0:
            return
        frozen = [self.stem] if self.deep_stem else [self.conv1, self.bn1]
        frozen += [getattr(self, f'layer{i}')
                   for i in range(1, self.frozen_stages + 1)]
        for m in frozen:
            m.eval()
            for p in m.parameters():
                p.requires_grad = False

    def train(self, mode: bool = True):
        super().train(mode)
        self._freeze_stages()
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x, generator=None):
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return outs


@BACKBONES.register_module()
class ResNetV1c(ResNet):
    """ResNet with the deep 3x3 stem (JAX ``resnet.py:270``)."""

    deep_stem_default = True


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """The deep stem and average-pool downsampling (JAX
    ``resnet.py:277``)."""

    deep_stem_default = True
    avg_down_default = True
