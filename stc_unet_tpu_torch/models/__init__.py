from .backbones import *  # noqa: F401,F403 (registers the backbones)
from .builder import (BACKBONES, HEADS, LOSSES, NECKS, SEGMENTORS,
                      build_backbone, build_head, build_loss, build_neck,
                      build_segmentor)
from .decode_heads import *  # noqa: F401,F403
from .losses import *  # noqa: F401,F403
from .necks import *  # noqa: F401,F403
from .segmentors import *  # noqa: F401,F403

__all__ = ['BACKBONES', 'HEADS', 'LOSSES', 'NECKS', 'SEGMENTORS',
           'build_backbone', 'build_head', 'build_loss', 'build_neck',
           'build_segmentor']
