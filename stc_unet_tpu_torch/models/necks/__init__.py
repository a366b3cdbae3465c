from .fpn import FPN
from .jpu import JPU
from .misc_necks import Feature2Pyramid, MLANeck, MultiLevelNeck

__all__ = ['FPN', 'JPU', 'Feature2Pyramid', 'MLANeck', 'MultiLevelNeck']
