"""Host-side image ops (≙ ``stc_unet_tpu/utils/image.py``), on numpy.

The JAX package calls cv2 for these; the port reads and writes PNG itself
(``utils/png.py``) and resizes in float32 numpy, so it needs neither cv2
nor Pillow. Conventions follow the JAX module: images are BGR uint8 HWC
from ``imread``; ``size`` arguments are (w, h) tuples.

``imresize`` follows cv2's mappings. ``'bilinear'`` is ``INTER_LINEAR``:
source coordinates at half-pixel centres, ``(x + 0.5) * w_in / w_out -
0.5``, no antialiasing. On ``uint8`` it is cv2's fixed-point arithmetic,
bit for bit (:func:`_resize_linear_u8`); other dtypes are computed in
float32, clamped to the edge, integers rounded half to even.
``'nearest'`` is ``INTER_NEAREST``: source index ``floor(x * (1 / (w_out
/ w_in)))`` in float64, clamped. At an unchanged size both return an
exact copy, as cv2 does. The other cv2 modes (bicubic, area, lanczos) are
not ported.

``bgr2hsv`` and ``hsv2bgr`` are cv2's ``COLOR_BGR2HSV`` and
``COLOR_HSV2BGR`` on ``uint8`` (H in [0, 180)), bit for bit: the forward
one in cv2's 12-bit fixed point with its division tables, the inverse one
in float32 with cv2's fused ``1 - s·h``, truncated to ``uint8`` in each
row's 32-pixel blocks and rounded in the rest, as cv2's AVX2 code and its
scalar tail do.
``impad`` pads with a constant, as ``cv2.copyMakeBorder`` does.
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


# cv2's INTER_LINEAR on uint8: weights in 11 fractional bits
_COEF_BITS = 11
_COEF_ONE = 1 << _COEF_BITS


def _linear_taps(dst: int, src: int, clamp: bool):
    """cv2's taps of one axis: (lower index, upper index, lower weight,
    upper weight), weights rounded to 11 bits each from a float32
    fraction. ``clamp`` is cv2's horizontal rule (a tap past an edge gets
    the edge pixel at weight 1); its vertical rule keeps the fraction and
    reads the edge row twice."""
    scale = 1.0 / (dst / src)
    x = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    lo = np.floor(x).astype(np.int64)
    frac = (x - lo.astype(np.float32)).astype(np.float32)
    if clamp:
        frac[lo < 0] = 0
        lo[lo < 0] = 0
        past = lo >= src - 1
        frac[past] = 0
        lo[past] = src - 1
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_ONE))
    w1 = np.rint(frac * np.float32(_COEF_ONE))
    return (np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1),
            w0.astype(np.int32), w1.astype(np.int32))


def _resize_linear_u8(img: np.ndarray, new_w: int, new_h: int):
    """cv2's ``INTER_LINEAR`` on uint8: rows weighted in int32 at 2^11,
    then each output row from two such rows as cv2's vertical pass does,
    ``(((b0·(r0 >> 4)) >> 16) + ((b1·(r1 >> 4)) >> 16) + 2) >> 2``."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(new_w, w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(new_h, h, clamp=False)
    cols = (-1,) + (1,) * (img.ndim - 2)
    src = img.astype(np.int32)
    rows = (src[:, x0] * a0.reshape(cols) + src[:, x1] * a1.reshape(cols)
            ) >> 4
    lines = (-1,) + (1,) * (img.ndim - 1)
    out = ((b0.reshape(lines) * rows[y0]) >> 16) + \
        ((b1.reshape(lines) * rows[y1]) >> 16)
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


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
    elif img.dtype == np.uint8:
        resized = _resize_linear_u8(img, new_w, new_h)
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


def impad(img: np.ndarray, *, shape=None, padding=None, pad_val=0,
          padding_mode: str = 'constant') -> np.ndarray:
    """Pad to ``shape`` = (h, w) at the bottom and right, or by
    ``padding`` = (left, top, right, bottom) (an int, or (x, y), for all
    four), with ``pad_val`` as ``cv2.copyMakeBorder`` takes it: one
    value per channel, or a number, which fills the first channel and
    leaves 0 in the others; integer images saturate it. Only
    ``padding_mode='constant'`` is ported."""
    if (shape is None) == (padding is None):
        raise ValueError('impad: give exactly one of shape and padding')
    if padding_mode != 'constant':
        raise NotImplementedError(
            f'impad: padding_mode {padding_mode!r} is not ported; '
            f"'constant' only")
    if shape is not None:
        padding = (0, 0, max(shape[1] - img.shape[1], 0),
                   max(shape[0] - img.shape[0], 0))
    if isinstance(padding, (int, np.integer)):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = (int(p) for p in padding)
    h, w = img.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + img.shape[2:],
                   img.dtype)
    fill = np.zeros(img.shape[2] if img.ndim == 3 else 1)
    values = np.atleast_1d(np.asarray(pad_val, np.float64))
    fill[:len(values)] = values[:len(fill)]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        fill = np.clip(np.rint(fill), info.min, info.max)
    out[...] = fill.astype(img.dtype) if img.ndim == 3 else \
        fill[0].astype(img.dtype)
    out[top:top + h, left:left + w] = img
    return out


def impad_to_multiple(img: np.ndarray, divisor: int,
                      pad_val=0) -> np.ndarray:
    """Pad at the bottom and right up to multiples of ``divisor``."""
    pad_h = int(np.ceil(img.shape[0] / divisor)) * divisor
    pad_w = int(np.ceil(img.shape[1] / divisor)) * divisor
    return impad(img, shape=(pad_h, pad_w), pad_val=pad_val)


# cv2's COLOR_BGR2HSV on uint8: 12-bit fixed point with division tables
_HSV_SHIFT = 12
_DIV = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIV)]).astype(
    np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6 * _DIV))]
                       ).astype(np.int32)
# COLOR_HSV2BGR: which of (v, v(1-s), v(1-sh), v(1-s(1-h))) goes to b, g, r
# in each of the six sectors; and the pixels of cv2's vector block (32 in
# its AVX2 code, which its x86-64 builds dispatch to)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
_HSV_VECTOR_PIXELS = 32


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """A BGR uint8 image as cv2's ``COLOR_BGR2HSV`` gives it: H in
    [0, 180), S and V in [0, 255], bit for bit."""
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    round_half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + round_half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + round_half) >> _HSV_SHIFT
    h[h < 0] += 180
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """An HSV uint8 image (H in [0, 180)) as cv2's ``COLOR_HSV2BGR``
    gives it, bit for bit: float32 throughout, ``1 - s·h`` fused into one
    rounding (computed in float64 from float32 operands, exact before its
    one rounding). cv2 converts each row in blocks of
    ``_HSV_VECTOR_PIXELS`` pixels with vector code, which truncates to
    uint8, and the row's remaining pixels with scalar code, which rounds
    half to even."""
    f32 = np.float32
    one = f32(1)
    h = img[..., 0].astype(f32) * f32(6.0 / 180)
    s = img[..., 1].astype(f32) * f32(1.0 / 255)
    v = img[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    h -= sector
    sector = sector.astype(np.intp) % 6

    def fused(frac):   # 1 - s * frac, rounded once
        return (1.0 - s.astype(np.float64) * frac).astype(f32)

    tab = np.stack([v, v * (one - s), v * fused(h), v * fused(one - h)], -1)
    out = np.take_along_axis(tab, _SECTORS[sector], -1)
    out *= f32(255)
    vector = out.shape[-2] // _HSV_VECTOR_PIXELS * _HSV_VECTOR_PIXELS
    np.trunc(out[..., :vector, :], out=out[..., :vector, :])
    np.rint(out[..., vector:, :], out=out[..., vector:, :])
    return np.clip(out, 0, 255).astype(np.uint8)
