"""Formatting transforms (≙
``stc_unet_tpu/datasets/pipelines/formatting.py``).

As in the JAX package, images stay float32 HWC numpy (the port's segmentor
takes NHWC) and ``img_metas`` is a plain dict.
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES


@PIPELINES.register_module()
class ImageToTensor:
    """Image to a model-ready array: float32 HWC, a gray image given one
    channel."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            img = results[key]
            if img.ndim < 3:
                img = np.expand_dims(img, -1)
            results[key] = np.ascontiguousarray(img.astype(np.float32))
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(keys={self.keys})'


@PIPELINES.register_module()
class Collect:
    """Collect data keys and meta: ``{'img_metas': {meta_key: value}, key:
    array}``."""

    DEFAULT_META_KEYS = ('filename', 'ori_filename', 'ori_shape', 'img_shape',
                         'pad_shape', 'scale_factor', 'flip',
                         'flip_direction', 'img_norm_cfg')

    def __init__(self, keys, meta_keys=DEFAULT_META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {'img_metas': {key: results[key] for key in self.meta_keys
                              if key in results}}
        for key in self.keys:
            data[key] = results[key]
        return data

    def __repr__(self):
        return (f'{self.__class__.__name__}(keys={self.keys}, '
                f'meta_keys={self.meta_keys})')


@PIPELINES.register_module()
class DefaultFormatBundle:
    """The train batch's arrays: the image as float32 HWC (a gray image
    given one channel), ``gt_semantic_seg`` as int64 (H, W)."""

    def __call__(self, results):
        if 'img' in results:
            img = results['img']
            if img.ndim < 3:
                img = np.expand_dims(img, -1)
            results['img'] = np.ascontiguousarray(img.astype(np.float32))
        if 'gt_semantic_seg' in results:
            results['gt_semantic_seg'] = results['gt_semantic_seg'].astype(
                np.int64)
        return results

    def __repr__(self):
        return self.__class__.__name__
