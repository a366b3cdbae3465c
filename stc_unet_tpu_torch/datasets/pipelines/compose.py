"""Sequential dict pipeline (≙
``stc_unet_tpu/datasets/pipelines/compose.py``)."""
from __future__ import annotations

import collections.abc

from ..builder import PIPELINES


@PIPELINES.register_module()
class Compose:
    """Compose transforms built from cfg dicts or callables."""

    def __init__(self, transforms):
        if not isinstance(transforms, collections.abc.Sequence):
            raise TypeError('transforms must be a sequence')
        self.transforms = []
        for transform in transforms:
            if isinstance(transform, dict):
                self.transforms.append(PIPELINES.build(transform))
            elif callable(transform):
                self.transforms.append(transform)
            else:
                raise TypeError('transform must be callable or a dict')

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
            if data is None:
                return None
        return data

    def __repr__(self):
        inner = ',\n    '.join(repr(t) for t in self.transforms)
        return f'{self.__class__.__name__}(\n    {inner}\n)'
