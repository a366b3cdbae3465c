"""Test-time augmentation (≙
``stc_unet_tpu/datasets/pipelines/test_time_aug.py``).

Expands one sample into scale × flip variants, each run through the inner
transforms; each key's results are collected into a list (the aug axis
that the segmentor's ``aug_test`` averages over).
"""
from __future__ import annotations

import warnings

from ..builder import PIPELINES
from .compose import Compose


def _check(ok, message):
    if not ok:
        raise ValueError(f'MultiScaleFlipAug: {message}')


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Three scale modes: explicit ``img_scale`` (a (w, h) tuple or a list
    of them); one ``img_scale`` times each of ``img_ratios``; or
    ``img_scale=None`` with ``img_ratios`` on each image's own shape. Each
    scale runs unflipped and, with ``flip``, flipped in each of
    ``flip_direction``."""

    def __init__(self, transforms, img_scale, img_ratios=None, flip=False,
                 flip_direction='horizontal'):
        if flip:
            trans_index = {t['type']: i for i, t in enumerate(transforms)}
            if 'RandomFlip' in trans_index and 'Pad' in trans_index:
                _check(trans_index['RandomFlip'] < trans_index['Pad'],
                       'Pad must be executed after RandomFlip when flip is '
                       'True')
        self.transforms = Compose(transforms)
        if img_ratios is not None:
            img_ratios = img_ratios if isinstance(img_ratios, list) \
                else [img_ratios]
            _check(all(isinstance(r, float) for r in img_ratios),
                   'img_ratios must be float(s)')
        if img_scale is None:
            # ratios of each image's own shape
            _check(img_ratios is not None,
                   'img_scale=None requires float img_ratios')
            self.img_scale = None
            self.img_ratios = img_ratios
        elif isinstance(img_scale, tuple) and img_ratios is not None:
            # one scale times each ratio
            _check(len(img_scale) == 2, 'img_scale must be (w, h)')
            self.img_scale = [(int(img_scale[0] * ratio),
                               int(img_scale[1] * ratio))
                              for ratio in img_ratios]
            self.img_ratios = img_ratios
        else:
            # explicit scale(s)
            self.img_scale = img_scale if isinstance(img_scale, list) \
                else [img_scale]
            self.img_ratios = None
        _check(self.img_scale is None or
               all(isinstance(s, tuple) for s in self.img_scale),
               'img_scale must be None, a tuple or a list of tuples')
        self.flip = flip
        self.flip_direction = flip_direction if isinstance(
            flip_direction, list) else [flip_direction]
        _check(all(isinstance(d, str) for d in self.flip_direction),
               'flip_direction must be str(s)')
        if not self.flip and self.flip_direction != ['horizontal']:
            warnings.warn(
                'flip_direction has no effect when flip is set to False')
        if self.flip and not any(
                t['type'] == 'RandomFlip' for t in transforms):
            warnings.warn(
                'flip has no effect when RandomFlip is not in transforms')

    def __call__(self, results):
        if self.img_scale is None:
            h, w = results['img'].shape[:2]
            img_scale = [(int(w * ratio), int(h * ratio))
                         for ratio in self.img_ratios]
        else:
            img_scale = self.img_scale
        flip_aug = [False, True] if self.flip else [False]
        aug_data = []
        for scale in img_scale:
            for flip in flip_aug:
                for direction in self.flip_direction:
                    _results = results.copy()
                    _results['scale'] = scale
                    _results['flip'] = flip
                    _results['flip_direction'] = direction
                    aug_data.append(self.transforms(_results))
        # list of dicts → dict of lists
        return {key: [data[key] for data in aug_data] for key in aug_data[0]}

    def __repr__(self):
        return (f'{self.__class__.__name__}(transforms={self.transforms}, '
                f'img_scale={self.img_scale}, flip={self.flip}, '
                f'flip_direction={self.flip_direction})')
