"""Model registries and build functions
(≙ ``stc_unet_tpu/models/builder.py``).

Registered classes are ``nn.Module``s (backbones, necks, heads,
segmentors), or plain loss callables in ``LOSSES``; ``build_*`` instantiates from an mmcv-style cfg dict keyed on
``type``.
"""
from __future__ import annotations

from stc_unet_tpu_torch.utils import Registry

BACKBONES = Registry('backbone')
NECKS = Registry('neck')
HEADS = Registry('head')
LOSSES = Registry('loss')
SEGMENTORS = Registry('segmentor')


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg, default_args=None):
    return NECKS.build(cfg, default_args=default_args)


def build_head(cfg, default_args=None):
    return HEADS.build(cfg, default_args=default_args)


def build_loss(cfg):
    return LOSSES.build(cfg)


def build_segmentor(cfg, train_cfg=None, test_cfg=None):
    """Build a segmentor; ``train_cfg``/``test_cfg`` may come from outside
    the model dict, but not from both places."""
    cfg = dict(cfg)
    if train_cfg is not None or test_cfg is not None:
        assert cfg.get('train_cfg') is None and cfg.get('test_cfg') is None, \
            'train_cfg/test_cfg specified in both outer field and model field'
    cfg.setdefault('train_cfg', train_cfg)
    cfg.setdefault('test_cfg', test_cfg)
    return SEGMENTORS.build(cfg)
