"""Loading transforms (≙ ``stc_unet_tpu/datasets/pipelines/loading.py``),
on the port's own PNG reader (``utils/png.py``)."""
from __future__ import annotations

import os.path as osp

import numpy as np

from stc_unet_tpu_torch.utils import image as mmimg
from stc_unet_tpu_torch.utils import png
from ..builder import PIPELINES
from .img_cache import build_img_cache


def imread_annotation(path) -> np.ndarray:
    """A segmentation map as stored → uint8 (H, W): what the JAX package's
    ``np.array(PIL.Image.open(path))[..., 0]`` gives (palette maps keep
    their indices)."""
    gt = png.read(path)
    if gt.ndim == 3:
        gt = gt[:, :, 0]
    return gt.astype(np.uint8)


@PIPELINES.register_module()
class LoadImageFromFile:
    """Load a BGR uint8 image and seed the shape and scale meta (≙ the JAX
    ``LoadImageFromFile``), through the decoded-image cache with
    ``cache='ram'|'disk'``."""

    def __init__(self, to_float32=False, color_type='color',
                 file_client_args=None, imdecode_backend='cv2',
                 cache=None, cache_dir=None):
        self.to_float32 = to_float32
        self.color_type = color_type
        self.imdecode_backend = imdecode_backend
        self.cache = build_img_cache(
            cache, cache_dir, params=('img', color_type, imdecode_backend))

    def _decode(self, filename):
        return mmimg.imread(filename, flag=self.color_type,
                            backend=self.imdecode_backend)

    def __call__(self, results):
        if results.get('img_prefix') is not None:
            filename = osp.join(results['img_prefix'],
                                results['img_info']['filename'])
        else:
            filename = results['img_info']['filename']
        if self.cache is not None:
            img = self.cache.get(filename, self._decode)
        else:
            img = self._decode(filename)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = filename
        results['ori_filename'] = results['img_info']['filename']
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = 1.0
        num_channels = 1 if len(img.shape) < 3 else img.shape[2]
        results['img_norm_cfg'] = dict(
            mean=np.zeros(num_channels, dtype=np.float32),
            std=np.ones(num_channels, dtype=np.float32),
            to_rgb=False)
        return results

    def __repr__(self):
        cache = self.cache.mode if self.cache is not None else None
        return (f'{self.__class__.__name__}(to_float32={self.to_float32}, '
                f"color_type='{self.color_type}', "
                f"imdecode_backend='{self.imdecode_backend}', "
                f'cache={cache!r})')


@PIPELINES.register_module()
class LoadAnnotations:
    """Load the semantic segmentation map (≙ the JAX ``LoadAnnotations``):
    read as stored → uint8 (through the decoded-image cache with
    ``cache='ram'|'disk'``), the custom-classes ``label_map`` remap, then
    ``reduce_zero_label``."""

    def __init__(self, reduce_zero_label=False, file_client_args=None,
                 imdecode_backend='pillow', cache=None, cache_dir=None):
        self.reduce_zero_label = reduce_zero_label
        self.imdecode_backend = imdecode_backend
        # the raw decode is cached: the remaps below write into the served
        # array
        self.cache = build_img_cache(cache, cache_dir,
                                     params=('ann', imdecode_backend))

    def __call__(self, results):
        if results.get('seg_prefix', None) is not None:
            filename = osp.join(results['seg_prefix'],
                                results['ann_info']['seg_map'])
        else:
            filename = results['ann_info']['seg_map']
        if self.cache is not None:
            gt_semantic_seg = self.cache.get(filename, imread_annotation)
        else:
            gt_semantic_seg = imread_annotation(filename)
        if results.get('label_map', None) is not None:
            gt_copy = gt_semantic_seg.copy()
            for old_id, new_id in results['label_map'].items():
                gt_semantic_seg[gt_copy == old_id] = new_id
        if self.reduce_zero_label:
            gt_semantic_seg[gt_semantic_seg == 0] = 255
            gt_semantic_seg = gt_semantic_seg - 1
            gt_semantic_seg[gt_semantic_seg == 254] = 255
        results['gt_semantic_seg'] = gt_semantic_seg
        results['seg_fields'].append('gt_semantic_seg')
        return results

    def __repr__(self):
        cache = self.cache.mode if self.cache is not None else None
        return (f'{self.__class__.__name__}'
                f'(reduce_zero_label={self.reduce_zero_label}, '
                f"imdecode_backend='{self.imdecode_backend}', "
                f'cache={cache!r})')


@PIPELINES.register_module()
class LoadImage:
    """The inference API's first step: a path or an ndarray (≙ the JAX
    ``LoadImage``)."""

    def __call__(self, results):
        img = results['img']
        if isinstance(img, str):
            results['filename'] = img
            results['ori_filename'] = img
            img = mmimg.imread(img)
        else:
            results['filename'] = None
            results['ori_filename'] = None
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results.setdefault('pad_shape', img.shape)
        results.setdefault('scale_factor', 1.0)
        results.setdefault('seg_fields', [])
        return results
