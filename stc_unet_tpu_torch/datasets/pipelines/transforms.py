"""The test path's transforms (≙
``stc_unet_tpu/datasets/pipelines/transforms.py``):
``Resize`` in every mode that draws nothing at random, ``RandomFlip`` with
``flip`` already set (by ``MultiScaleFlipAug``), and ``Normalize``. The
random scale modes and the random flip draw come with the training data
(ROADMAP.md §1, Item 12b) and raise until then.
"""
from __future__ import annotations

import numpy as np

from stc_unet_tpu_torch.utils import image as mmimg
from ..builder import PIPELINES

_RANDOM = 'is not ported yet (ROADMAP.md §1, Item 12b: the training data)'


@PIPELINES.register_module()
class Resize:
    """Resize the image and its segmentation maps (≙ the JAX ``Resize``).

    ``img_scale`` tuples are (w, h), like mmcv. The scale comes from
    ``results['scale']`` (set by ``MultiScaleFlipAug``) or from a single
    ``img_scale``; ``keep_ratio`` rescales into the scale box (with
    ``min_size``, the short edge at least that), otherwise the image is
    resized to the scale exactly. Drawing a scale at random (several
    ``img_scale``, or ``ratio_range``) raises.
    """

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None, keep_ratio=True, min_size=None):
        if img_scale is None:
            self.img_scale = None
        else:
            self.img_scale = img_scale if isinstance(img_scale, list) \
                else [img_scale]
            if not all(isinstance(s, tuple) for s in self.img_scale):
                raise TypeError('Resize: img_scale must be tuples')
        if ratio_range is not None:
            if self.img_scale is not None and len(self.img_scale) != 1:
                raise ValueError('Resize: ratio_range takes one img_scale')
        elif multiscale_mode not in ('value', 'range'):
            raise ValueError(f'Resize: multiscale_mode {multiscale_mode!r}')
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.min_size = min_size

    def _scale(self, results):
        if self.ratio_range is not None:
            raise NotImplementedError(f'Resize: a ratio_range draw {_RANDOM}')
        if self.img_scale is None:
            raise ValueError('Resize: no img_scale and no results["scale"]')
        if len(self.img_scale) > 1:
            raise NotImplementedError(
                f'Resize: drawing one of several img_scale ('
                f'{self.multiscale_mode!r}) {_RANDOM}')
        results['scale'] = self.img_scale[0]
        results['scale_idx'] = 0

    def _resize_img(self, results):
        img = results['img']
        if self.keep_ratio:
            if self.min_size is not None:
                # scale the short edge up to at least min_size
                new_short = max(min(results['scale']), self.min_size)
                h, w = img.shape[:2]
                if h < w:
                    new_h, new_w = new_short, new_short * w / h
                else:
                    new_h, new_w = new_short * h / w, new_short
                results['scale'] = (int(new_w), int(new_h))
            img = mmimg.imrescale(img, results['scale'])
            new_h, new_w = img.shape[:2]
            h, w = results['img'].shape[:2]
            w_scale = new_w / w
            h_scale = new_h / h
        else:
            img, w_scale, h_scale = mmimg.imresize(img, results['scale'],
                                                   return_scale=True)
        results['img'] = img
        results['img_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], dtype=np.float32)
        results['keep_ratio'] = self.keep_ratio

    def _resize_seg(self, results):
        for key in results.get('seg_fields', []):
            if self.keep_ratio:
                results[key] = mmimg.imrescale(
                    results[key], results['scale'], interpolation='nearest')
            else:
                results[key] = mmimg.imresize(
                    results[key], results['scale'], interpolation='nearest')

    def __call__(self, results):
        if 'scale' not in results:
            self._scale(results)
        self._resize_img(results)
        self._resize_seg(results)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(img_scale={self.img_scale}, '
                f'multiscale_mode={self.multiscale_mode}, '
                f'ratio_range={self.ratio_range}, '
                f'keep_ratio={self.keep_ratio})')


@PIPELINES.register_module()
class RandomFlip:
    """Flip the image and its segmentation maps when ``results['flip']``
    says so (≙ the JAX ``RandomFlip``; ``flip_ratio`` is the legacy alias
    of ``prob``). Without ``results['flip']`` the flip would be drawn at
    random, which raises."""

    def __init__(self, prob=None, direction='horizontal', flip_ratio=None):
        if prob is None:
            prob = flip_ratio
        if prob is not None and not 0 <= prob <= 1:
            raise ValueError(f'RandomFlip: prob {prob} not in [0, 1]')
        if direction not in ('horizontal', 'vertical'):
            raise ValueError(f'RandomFlip: direction {direction!r}')
        self.prob = prob
        self.direction = direction

    def __call__(self, results):
        if 'flip' not in results:
            raise NotImplementedError(f'RandomFlip: the random draw {_RANDOM}')
        if 'flip_direction' not in results:
            results['flip_direction'] = self.direction
        if results['flip']:
            results['img'] = mmimg.imflip(
                results['img'], direction=results['flip_direction'])
            for key in results.get('seg_fields', []):
                results[key] = mmimg.imflip(
                    results[key], direction=results['flip_direction']).copy()
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(prob={self.prob})'


@PIPELINES.register_module()
class Normalize:
    """Normalize the image: float32 ``(img - mean) / std``, BGR→RGB first
    with ``to_rgb``."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        results['img'] = mmimg.imnormalize(results['img'], self.mean,
                                           self.std, self.to_rgb)
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(mean={list(self.mean)}, '
                f'std={list(self.std)}, to_rgb={self.to_rgb})')
