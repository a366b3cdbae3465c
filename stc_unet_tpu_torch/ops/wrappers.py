"""Image resize on NHWC tensors over ``F.interpolate``.

Counterpart of ``stc_unet_tpu/ops/wrappers.py``. The JAX ``resize`` was
built to match ``F.interpolate``; here it is ``F.interpolate``, behind the
JAX function's NHWC signature: spatial axes are (1, 2) of a 4D tensor. A
literal ``scale_factor`` is passed through, so the source-coordinate math
uses it as torch's ``recompute_scale_factor=None`` does. An NHWC view of a
``channels_last`` tensor goes in and comes out without a copy.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def resize(input: torch.Tensor,
           size: Optional[Tuple[int, int]] = None,
           scale_factor: Optional[Union[float, Tuple[float, float]]] = None,
           mode: str = 'bilinear',
           align_corners: Optional[bool] = None,
           warning: bool = True) -> torch.Tensor:
    """Resize an (N, H, W, C) tensor; see ``F.interpolate``."""
    if input.ndim != 4:
        raise ValueError(f'resize expects a 4D NHWC tensor, got '
                         f'{tuple(input.shape)}')
    in_h, in_w = input.shape[1], input.shape[2]
    if size is None:
        if scale_factor is None:
            raise ValueError('either size or scale_factor must be given')
        sh, sw = (scale_factor if isinstance(scale_factor, (tuple, list))
                  else (scale_factor, scale_factor))
        out_h, out_w = int(in_h * sh), int(in_w * sw)
    else:
        out_h, out_w = int(size[0]), int(size[1])
    if (out_h, out_w) == (in_h, in_w):
        return input
    if warning and align_corners and out_h > in_h:
        if ((out_h > 1 and out_w > 1 and in_h > 1 and in_w > 1)
                and (out_h - 1) % (in_h - 1) and (out_w - 1) % (in_w - 1)):
            warnings.warn(
                f'When align_corners={align_corners}, the output would be '
                'more aligned if input/output sizes satisfy '
                '(out-1) % (in-1) == 0', stacklevel=2)
    if mode == 'nearest' and align_corners is not None:
        raise ValueError('align_corners is not applicable for nearest')
    kwargs = ({} if mode == 'nearest'
              else {'align_corners': bool(align_corners)})
    if size is None:
        kwargs['scale_factor'] = scale_factor
    else:
        kwargs['size'] = (out_h, out_w)
    out = F.interpolate(input.permute(0, 3, 1, 2), mode=mode, **kwargs)
    return out.permute(0, 2, 3, 1)


class Upsample:
    """Callable wrapper over :func:`resize` (NHWC)."""

    def __init__(self, size=None, scale_factor=None, mode='nearest',
                 align_corners=None):
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def __call__(self, x):
        if not self.size:
            size = [int(t * self.scale_factor) for t in x.shape[1:3]]
        else:
            size = self.size
        return resize(x, size=tuple(size), mode=self.mode,
                      align_corners=self.align_corners, warning=False)
