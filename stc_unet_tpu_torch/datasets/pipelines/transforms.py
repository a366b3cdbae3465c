"""The transforms of the train and test pipelines (≙
``stc_unet_tpu/datasets/pipelines/transforms.py``): ``Resize`` with its
random scale modes, ``RandomFlip``, ``RandomCrop``,
``PhotoMetricDistortion``, ``Normalize`` and ``Pad``.

Every random draw comes from the ``numpy.random.RandomState`` in
``results['rng']``, which the train loader hands in, one for each sample
(``datasets/builder.py``), never from the global ``np.random``. A
transform that must draw and finds no ``rng`` raises. Each transform makes
the calls of the JAX transform in the same order with the same ranges, so
a ``RandomState(s)`` here draws what ``np.random.seed(s)`` makes the JAX
transform draw.
"""
from __future__ import annotations

import numpy as np

from stc_unet_tpu_torch.utils import image as mmimg
from ..builder import PIPELINES


def _rng(results, what: str) -> np.random.RandomState:
    rng = results.get('rng')
    if rng is None:
        raise ValueError(
            f'{what} draws at random and results has no "rng": hand it a '
            f'numpy RandomState (the train loader gives each sample one)')
    return rng


@PIPELINES.register_module()
class Resize:
    """Resize the image and its segmentation maps (≙ the JAX ``Resize``).

    ``img_scale`` tuples are (w, h), like mmcv. The scale comes from
    ``results['scale']`` (set by ``MultiScaleFlipAug``), from a single
    ``img_scale``, or is drawn: ``ratio_range`` scales the one
    ``img_scale`` (or the image's own size) by a ratio drawn in it;
    several ``img_scale`` give a long and a short edge drawn between them
    (``multiscale_mode='range'``) or one of them (``'value'``).
    ``keep_ratio`` rescales into the scale box (with ``min_size``, the
    short edge at least that), otherwise the image is resized to the
    scale exactly.
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

    @staticmethod
    def random_select(img_scales, rng):
        scale_idx = rng.randint(len(img_scales))
        return img_scales[scale_idx], scale_idx

    @staticmethod
    def random_sample(img_scales, rng):
        if len(img_scales) != 2:
            raise ValueError('Resize: the range mode takes two img_scale')
        img_scale_long = [max(s) for s in img_scales]
        img_scale_short = [min(s) for s in img_scales]
        long_edge = rng.randint(min(img_scale_long),
                                max(img_scale_long) + 1)
        short_edge = rng.randint(min(img_scale_short),
                                 max(img_scale_short) + 1)
        return (long_edge, short_edge), None

    @staticmethod
    def random_sample_ratio(img_scale, ratio_range, rng):
        min_ratio, max_ratio = ratio_range
        if min_ratio > max_ratio:
            raise ValueError(f'Resize: ratio_range {ratio_range}')
        ratio = rng.random_sample() * (max_ratio - min_ratio) + min_ratio
        return (int(img_scale[0] * ratio), int(img_scale[1] * ratio)), None

    def _scale(self, results):
        if self.ratio_range is not None:
            base = self.img_scale[0] if self.img_scale is not None else \
                results['img'].shape[1::-1]
            scale, scale_idx = self.random_sample_ratio(
                base, self.ratio_range, _rng(results, 'Resize'))
        elif self.img_scale is None:
            raise ValueError('Resize: no img_scale and no results["scale"]')
        elif len(self.img_scale) == 1:
            scale, scale_idx = self.img_scale[0], 0
        elif self.multiscale_mode == 'range':
            scale, scale_idx = self.random_sample(self.img_scale,
                                                  _rng(results, 'Resize'))
        else:
            scale, scale_idx = self.random_select(self.img_scale,
                                                  _rng(results, 'Resize'))
        results['scale'] = scale
        results['scale_idx'] = scale_idx

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
    """Flip the image and its segmentation maps (≙ the JAX
    ``RandomFlip``; ``flip_ratio`` is the legacy alias of ``prob``): as
    ``results['flip']`` says (set by ``MultiScaleFlipAug``), or with
    probability ``prob``, drawn."""

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
            if self.prob is None:
                raise ValueError('RandomFlip: no prob to draw the flip with')
            results['flip'] = bool(_rng(results, 'RandomFlip').rand() <
                                   self.prob)
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


@PIPELINES.register_module()
class Pad:
    """Pad the image to ``size`` (h, w) or to multiples of
    ``size_divisor`` at the bottom and right with ``pad_val``, and the
    segmentation maps to the same shape with ``seg_pad_val``."""

    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 seg_pad_val=255):
        if (size is None) == (size_divisor is None):
            raise ValueError('Pad: give exactly one of size and '
                             'size_divisor')
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def __call__(self, results):
        if self.size is not None:
            img = mmimg.impad(results['img'], shape=self.size,
                              pad_val=self.pad_val)
        else:
            img = mmimg.impad_to_multiple(results['img'], self.size_divisor,
                                          pad_val=self.pad_val)
        results['img'] = img
        results['pad_shape'] = img.shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        for key in results.get('seg_fields', []):
            results[key] = mmimg.impad(results[key], shape=img.shape[:2],
                                       pad_val=self.seg_pad_val)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(size={self.size}, '
                f'size_divisor={self.size_divisor}, pad_val={self.pad_val})')


@PIPELINES.register_module()
class RandomCrop:
    """Crop ``crop_size`` (h, w) at a random offset (≙ the JAX
    ``RandomCrop``). Below ``cat_max_ratio`` the offset is drawn again, up
    to 10 times, until the crop holds two classes or more (``ignore_index``
    aside) and none takes ``cat_max_ratio`` of its labelled pixels. Classes
    are counted with ``np.bincount`` on uint8 maps, which decides as JAX's
    ``np.unique`` does."""

    def __init__(self, crop_size, cat_max_ratio=1., ignore_index=255):
        if crop_size[0] <= 0 or crop_size[1] <= 0:
            raise ValueError(f'RandomCrop: crop_size {crop_size}')
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def get_crop_bbox(self, img, rng):
        margin_h = max(img.shape[0] - self.crop_size[0], 0)
        margin_w = max(img.shape[1] - self.crop_size[1], 0)
        offset_h = rng.randint(0, margin_h + 1)
        offset_w = rng.randint(0, margin_w + 1)
        return (offset_h, offset_h + self.crop_size[0],
                offset_w, offset_w + self.crop_size[1])

    @staticmethod
    def crop(img, crop_bbox):
        y1, y2, x1, x2 = crop_bbox
        return img[y1:y2, x1:x2, ...]

    def _accepted(self, seg) -> bool:
        if seg.dtype == np.uint8:
            cnt = np.bincount(seg.ravel(), minlength=256)
            if 0 <= self.ignore_index < 256:
                cnt[self.ignore_index] = 0
            cnt = cnt[cnt > 0]
        else:
            labels, cnt = np.unique(seg, return_counts=True)
            cnt = cnt[labels != self.ignore_index]
        return len(cnt) > 1 and np.max(cnt) / np.sum(cnt) < \
            self.cat_max_ratio

    def __call__(self, results):
        rng = _rng(results, 'RandomCrop')
        img = results['img']
        crop_bbox = self.get_crop_bbox(img, rng)
        if self.cat_max_ratio < 1.:
            for _ in range(10):
                if self._accepted(self.crop(results['gt_semantic_seg'],
                                            crop_bbox)):
                    break
                crop_bbox = self.get_crop_bbox(img, rng)
        img = self.crop(img, crop_bbox)
        results['img'] = img
        results['img_shape'] = img.shape
        for key in results.get('seg_fields', []):
            results[key] = self.crop(results[key], crop_bbox)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(crop_size={self.crop_size})'


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter on a BGR uint8
    image, each applied with probability 0.5 (≙ the JAX
    ``PhotoMetricDistortion``): brightness, then contrast if the drawn
    ``mode`` is 1, saturation and hue in cv2's HSV, then contrast if
    ``mode`` is 0. ``convert`` clips to [0, 255] and truncates to uint8;
    the hue shift is drawn from ``randint(-hue_delta, hue_delta)``, which
    excludes ``+hue_delta``, as JAX's does."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def convert(img, alpha=1, beta=0):
        img = img.astype(np.float32) * alpha + beta
        return np.clip(img, 0, 255).astype(np.uint8)

    def brightness(self, img, rng):
        if rng.randint(2):
            return self.convert(img, beta=rng.uniform(-self.brightness_delta,
                                                      self.brightness_delta))
        return img

    def contrast(self, img, rng):
        if rng.randint(2):
            return self.convert(img, alpha=rng.uniform(self.contrast_lower,
                                                       self.contrast_upper))
        return img

    def saturation(self, img, rng):
        if rng.randint(2):
            img = mmimg.bgr2hsv(img)
            img[:, :, 1] = self.convert(
                img[:, :, 1], alpha=rng.uniform(self.saturation_lower,
                                                self.saturation_upper))
            img = mmimg.hsv2bgr(img)
        return img

    def hue(self, img, rng):
        if rng.randint(2):
            img = mmimg.bgr2hsv(img)
            img[:, :, 0] = (img[:, :, 0].astype(int) + rng.randint(
                -self.hue_delta, self.hue_delta)) % 180
            img = mmimg.hsv2bgr(img)
        return img

    def __call__(self, results):
        rng = _rng(results, 'PhotoMetricDistortion')
        img = self.brightness(results['img'], rng)
        mode = rng.randint(2)
        if mode == 1:
            img = self.contrast(img, rng)
        img = self.saturation(img, rng)
        img = self.hue(img, rng)
        if mode == 0:
            img = self.contrast(img, rng)
        results['img'] = img
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'(brightness_delta={self.brightness_delta}, '
                f'contrast_range=({self.contrast_lower}, '
                f'{self.contrast_upper}), '
                f'saturation_range=({self.saturation_lower}, '
                f'{self.saturation_upper}), hue_delta={self.hue_delta})')
