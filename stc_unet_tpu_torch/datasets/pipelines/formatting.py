"""Formatting transforms (≙
``stc_unet_tpu/datasets/pipelines/formatting.py``).

As in the JAX package, images stay float32 HWC numpy (the port's segmentor
takes NHWC) and ``img_metas`` is a plain dict. ``DeviceFormatBundle`` is
the host's last step when the train augmentation runs on the card
(``datasets/device_pipeline.py``).
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


@PIPELINES.register_module()
class DeviceFormatBundle:
    """The host's tail of the augmentation on the card
    (``datasets/device_pipeline.py``): pad ``img`` and ``gt_semantic_seg``
    at the bottom and right to one static ``size`` (h, w) with ``pad_val``
    and ``seg_pad_val``, emit them as **uint8** and add ``valid_hw``
    (int32, the un-padded extent). Every batch of an epoch then has one
    shape, and the upload stays uint8. A sample larger than ``size``
    raises: cropping it here would skew the crop's distribution."""

    def __init__(self, size, pad_val=0, seg_pad_val=255):
        self.size = tuple(size)
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def _pad(self, arr, val):
        h, w = arr.shape[:2]
        if h > self.size[0] or w > self.size[1]:
            raise ValueError(
                f'DeviceFormatBundle: sample {(h, w)} exceeds the static '
                f'host size {self.size}; set data.device_pipeline_size '
                f'to at least the largest Resize output')
        ph, pw = self.size[0] - h, self.size[1] - w
        if ph == 0 and pw == 0:
            return arr
        pad = ((0, ph), (0, pw)) + ((0, 0),) * (arr.ndim - 2)
        return np.pad(arr, pad, constant_values=val)

    def __call__(self, results):
        img = results['img']
        if img.ndim < 3:
            img = np.expand_dims(img, -1)
        results['valid_hw'] = np.asarray(
            [min(img.shape[0], self.size[0]),
             min(img.shape[1], self.size[1])], np.int32)
        results['img'] = np.ascontiguousarray(
            self._pad(img, self.pad_val).astype(np.uint8))
        if 'gt_semantic_seg' in results:
            results['gt_semantic_seg'] = np.ascontiguousarray(
                self._pad(results['gt_semantic_seg'],
                          self.seg_pad_val).astype(np.uint8))
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(size={self.size})'
