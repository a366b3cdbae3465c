"""BaseSegmentor (≙ ``stc_unet_tpu/models/segmentors/base.py``): the
protocol of the reference API on an ``nn.Module``:
``forward(return_loss=...)``, the ``simple_test``/``aug_test`` dispatch,
``train_step``/``val_step`` with ``_parse_losses``, and ``show_result``."""
from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Optional

import numpy as np
import torch.nn as nn

from stc_unet_tpu_torch.utils.util_distribution import allgather as \
    dist_allgather
from stc_unet_tpu_torch.utils.util_distribution import get_dist_info
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
        floats. Inside a process group of more than one rank the ranks'
        loss keys are checked first (:meth:`_check_loss_keys_consistent`)."""
        loss, log_vars = total_loss_from_dict(losses)
        BaseSegmentor._check_loss_keys_consistent(log_vars)
        return loss, {k: float(v.detach()) for k, v in log_vars.items()}

    @staticmethod
    def _check_loss_keys_consistent(log_vars, allgather=None,
                                    process_count=None, process_index=0):
        """Fail fast when the ranks' log vars differ in number (≙ the JAX
        ``_check_loss_keys_consistent``): every later collective of the
        step would otherwise mismatch or hang. ``allgather`` (an array to
        the ranks' stack), ``process_count`` and ``process_index`` are
        injectable for tests; by default they come from the initialised
        process group, and one process has nothing to check."""
        if process_count is None:
            process_index, process_count = get_dist_info()
            if process_count <= 1:
                return
            allgather = dist_allgather
        lengths = np.asarray(allgather(np.asarray(len(log_vars))))
        if int(lengths.sum()) != len(log_vars) * process_count:
            raise AssertionError(
                'loss log variables are different across ranks!\n'
                f'rank {process_index} len(log_vars): {len(log_vars)} '
                'keys: ' + ','.join(log_vars.keys()))

    # -- visualisation -------------------------------------------------------
    def show_result(self, img, result, palette=None, win_name='', show=False,
                    wait_time=0, out_file=None, opacity=0.5):
        """Blend a label map over a BGR image with the class palette (≙ the
        JAX ``show_result``, byte for byte): ``img·(1 - opacity) +
        color·opacity`` in float64, truncated to uint8, the palette's RGB
        colours put in BGR order. The palette is ``palette``, else the
        model's ``PALETTE``, else ``np.random.RandomState(42)``'s draw of
        one colour a label. ``img`` is an array or a PNG path. The blend
        is written to ``out_file`` as PNG (its directories made) and
        returned when there is no ``out_file``. ``show`` (a window)
        raises: the port needs no window toolkit, and the card's machine
        has none."""
        from stc_unet_tpu_torch.utils import image as mmimg
        if show:
            raise NotImplementedError(
                'show_result(show=True) opens a window, and the port has no '
                'window toolkit (the card\'s machine has none); pass '
                'out_file')
        img = np.ascontiguousarray(mmimg.imread(img))
        seg = np.asarray(result[0] if isinstance(result, list) else result)
        if palette is None:
            if self.PALETTE is None:
                rng = np.random.RandomState(42)
                palette = rng.randint(0, 255, size=(int(seg.max()) + 1, 3))
            else:
                palette = self.PALETTE
        palette = np.array(palette)
        if palette.ndim != 2 or palette.shape[1] != 3:
            raise ValueError(f'palette: (classes, 3) colours, got '
                             f'{palette.shape}')
        if not 0 < opacity <= 1.0:
            raise ValueError(f'opacity {opacity} is not in (0, 1]')
        color_seg = np.zeros((seg.shape[0], seg.shape[1], 3), dtype=np.uint8)
        for label, color in enumerate(palette):
            color_seg[seg == label, :] = color
        color_seg = color_seg[..., ::-1]
        out = (img * (1 - opacity) + color_seg * opacity).astype(np.uint8)
        if out_file is not None:
            mmimg.imwrite(out, out_file)
            return None
        return out
