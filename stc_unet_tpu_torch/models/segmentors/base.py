"""BaseSegmentor (≙ ``stc_unet_tpu/models/segmentors/base.py``): the test
protocol of the reference API, ``forward(return_loss=...)`` and the
``simple_test``/``aug_test`` dispatch, on an ``nn.Module``."""
from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Optional

import torch.nn as nn


class BaseSegmentor(nn.Module, metaclass=ABCMeta):
    """Base segmentor."""

    def __init__(self, init_cfg: Optional[dict] = None):
        super().__init__()
        self.init_cfg = init_cfg
        self.CLASSES = None
        self.PALETTE = None
        self.cfg = None

    @abstractmethod
    def extract_feat(self, imgs):
        pass

    @abstractmethod
    def encode_decode(self, img, img_metas):
        pass

    @abstractmethod
    def forward_train(self, img, img_metas, **kwargs):
        pass

    @abstractmethod
    def simple_test(self, img, img_meta, **kwargs):
        pass

    @abstractmethod
    def aug_test(self, imgs, img_metas, **kwargs):
        pass

    @abstractmethod
    def init_weights(self, seed: int = 0):
        pass

    def forward_test(self, imgs, img_metas, **kwargs):
        """TTA dispatch: 1 aug → simple_test, N augs → aug_test."""
        for var, name in [(imgs, 'imgs'), (img_metas, 'img_metas')]:
            if not isinstance(var, list):
                raise TypeError(f'{name} must be a list, got {type(var)}')
        num_augs = len(imgs)
        if num_augs != len(img_metas):
            raise ValueError(
                f'num of augmentations ({len(imgs)}) != num of image meta '
                f'({len(img_metas)})')
        for img_meta in img_metas:
            for key in ('ori_shape', 'img_shape', 'pad_shape'):
                shapes = [_[key] for _ in img_meta]
                assert all(shape == shapes[0] for shape in shapes)
        if num_augs == 1:
            return self.simple_test(imgs[0], img_metas[0], **kwargs)
        return self.aug_test(imgs, img_metas, **kwargs)

    def forward(self, img, img_metas=None, return_loss=True, **kwargs):
        """Train/test dispatch keyed on return_loss."""
        if return_loss:
            return self.forward_train(img, img_metas, **kwargs)
        return self.forward_test(img, img_metas, **kwargs)
