"""BaseSegmentor (≙ ``stc_unet_tpu/models/segmentors/base.py``): the
protocol of the reference API on an ``nn.Module``:
``forward(return_loss=...)``, the ``simple_test``/``aug_test`` dispatch,
and ``train_step``/``val_step`` with ``_parse_losses``."""
from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Optional

import torch.nn as nn

from ..losses.utils import total_loss_from_dict


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

    # -- train/val steps -----------------------------------------------------
    def train_step(self, data_batch, optimizer=None, **kwargs):
        """Losses and logs of one batch (reference API). The update is taken
        by ``engine.make_train_step``, not here."""
        losses = self(**data_batch)
        loss, log_vars = self._parse_losses(losses)
        return dict(loss=loss, log_vars=log_vars,
                    num_samples=len(data_batch['img_metas']))

    def val_step(self, data_batch, optimizer=None, **kwargs):
        return self.train_step(data_batch, optimizer, **kwargs)

    @staticmethod
    def _parse_losses(losses: dict):
        """Sum every ``*loss*`` entry into the total; the log vars as
        floats. The JAX package's cross-host check of the loss keys has
        nothing to check in one process; it comes with DDP (ROADMAP.md,
        Slice C item 14)."""
        loss, log_vars = total_loss_from_dict(losses)
        return loss, {k: float(v.detach()) for k, v in log_vars.items()}
