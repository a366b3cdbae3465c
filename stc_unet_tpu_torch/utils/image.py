"""Host-side image ops (≙ ``stc_unet_tpu/utils/image.py``), on numpy.

The JAX package calls cv2 for these; the port reads and writes PNG itself
(``utils/png.py``) and resizes in float32 numpy, so it needs neither cv2
nor Pillow. Conventions follow the JAX module: images are BGR uint8 HWC
from ``imread``; ``size`` arguments are (w, h) tuples.

``imresize`` follows cv2's mappings. ``'bilinear'`` is ``INTER_LINEAR``:
source coordinates at half-pixel centres, ``(x + 0.5) * w_in / w_out -
0.5``, clamped to the edge, no antialiasing; computed in float32 and
rounded half to even, where cv2 uses 11-bit fixed-point weights, so a
changed size can differ from cv2 by one level. ``'nearest'`` is
``INTER_NEAREST``: source index ``floor(x * (1 / (w_out / w_in)))`` in
float64, clamped. At an unchanged size both return an exact copy, as cv2
does. The other cv2 modes (bicubic, area, lanczos) are not ported.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Tuple

import numpy as np

from . import png

INTERPOLATIONS = ('nearest', 'bilinear')


def imread(path, flag: str = 'color', backend: str = 'cv2') -> np.ndarray:
    """Read a PNG as ``cv2.imread(path, IMREAD_COLOR)`` does: BGR uint8
    HWC. An ndarray passes through. Only ``flag='color'`` and
    ``backend='cv2'`` are ported."""
    if isinstance(path, np.ndarray):
        return path
    if not osp.isfile(path):
        raise FileNotFoundError(f'img file does not exist: {path}')
    if flag != 'color' or backend != 'cv2':
        raise ValueError(f"imread: flag {flag!r} with backend {backend!r} "
                         f"is not ported; flag='color', backend='cv2' only")
    return png.read_color(path)


def imwrite(img: np.ndarray, path: str) -> bool:
    """Write a BGR (H, W, 3) or gray (H, W) uint8 image as PNG, as
    ``cv2.imwrite`` does."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    img = np.asarray(img)
    png.write(path, img[:, :, ::-1] if img.ndim == 3 else img)
    return True


def _source_index(dst: int, src: int, interpolation: str):
    """Per output index: (lower source index, upper, weight of the upper)
    for 'bilinear'; the source index for 'nearest'."""
    if interpolation == 'nearest':
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                          src - 1)
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(x).astype(np.int64)
    frac = (x - lo).astype(np.float32)
    frac[lo < 0] = 0
    lo = np.clip(lo, 0, src - 1)
    frac[lo >= src - 1] = 0
    return lo, np.minimum(lo + 1, src - 1), frac


def imresize(img: np.ndarray, size: Tuple[int, int],
             return_scale: bool = False, interpolation: str = 'bilinear'):
    """Resize to ``size`` = (w, h), cv2's mapping (module docstring)."""
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f'imresize: interpolation {interpolation!r} is not '
                         f'ported; one of {INTERPOLATIONS}')
    h, w = img.shape[:2]
    new_w, new_h = int(size[0]), int(size[1])
    if (new_w, new_h) == (w, h):
        resized = img.copy()
    elif interpolation == 'nearest':
        rows = _source_index(new_h, h, 'nearest')
        cols = _source_index(new_w, w, 'nearest')
        resized = img[rows][:, cols]
    else:
        y0, y1, fy = _source_index(new_h, h, 'bilinear')
        x0, x1, fx = _source_index(new_w, w, 'bilinear')
        src = img.astype(np.float32)
        fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
        fx = fx.reshape((-1,) + (1,) * (img.ndim - 2))
        rows = src[y0] * (1 - fy) + src[y1] * fy
        out = rows[:, x0] * (1 - fx) + rows[:, x1] * fx
        if np.issubdtype(img.dtype, np.integer):
            info = np.iinfo(img.dtype)
            out = np.clip(np.rint(out), info.min, info.max)
        resized = out.astype(img.dtype)
    if not return_scale:
        return resized
    return resized, new_w / w, new_h / h


def rescale_size(old_size: Tuple[int, int], scale,
                 return_scale: bool = False):
    """New (w, h) after scaling with aspect kept (mmcv ``rescale_size``)."""
    w, h = old_size
    if isinstance(scale, (float, int)):
        scale_factor = scale
    elif isinstance(scale, (tuple, list)):
        max_long_edge = max(scale)
        max_short_edge = min(scale)
        scale_factor = min(max_long_edge / max(h, w),
                           max_short_edge / min(h, w))
    else:
        raise TypeError(f'Scale must be number or tuple of int, got {scale}')
    new_size = (int(w * scale_factor + 0.5), int(h * scale_factor + 0.5))
    if return_scale:
        return new_size, scale_factor
    return new_size


def imrescale(img: np.ndarray, scale, return_scale: bool = False,
              interpolation: str = 'bilinear'):
    """Resize keeping aspect so the image fits in ``scale`` (mmcv rule)."""
    h, w = img.shape[:2]
    new_size, scale_factor = rescale_size((w, h), scale, return_scale=True)
    rescaled = imresize(img, new_size, interpolation=interpolation)
    if return_scale:
        return rescaled, scale_factor
    return rescaled


def imflip(img: np.ndarray, direction: str = 'horizontal') -> np.ndarray:
    if direction not in ('horizontal', 'vertical', 'diagonal'):
        raise ValueError(f'imflip: unknown direction {direction!r}')
    if direction == 'horizontal':
        return np.flip(img, axis=1)
    if direction == 'vertical':
        return np.flip(img, axis=0)
    return np.flip(img, axis=(0, 1))


def imnormalize(img: np.ndarray, mean, std, to_rgb: bool = True) -> np.ndarray:
    """(img - mean) / std in float32; optional BGR→RGB first."""
    img = img.astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if to_rgb and img.ndim == 3 and img.shape[2] == 3:
        img = img[:, :, ::-1]
    return (img - mean) / std


def imdenormalize(img, mean, std, to_bgr: bool = True):
    img = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    if to_bgr and img.ndim == 3 and img.shape[2] == 3:
        img = img[:, :, ::-1]
    return img
