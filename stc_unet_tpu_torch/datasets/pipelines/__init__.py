from .compose import Compose
from .formatting import (Collect, DefaultFormatBundle, DeviceFormatBundle,
                         ImageToTensor)
from .loading import LoadAnnotations, LoadImage, LoadImageFromFile
from .test_time_aug import MultiScaleFlipAug
from .transforms import (Normalize, Pad, PhotoMetricDistortion, RandomCrop,
                         RandomFlip, Resize)

__all__ = ['Compose', 'Collect', 'DefaultFormatBundle', 'DeviceFormatBundle',
           'ImageToTensor', 'LoadAnnotations', 'LoadImage', 'LoadImageFromFile',
           'MultiScaleFlipAug', 'Normalize', 'Pad', 'PhotoMetricDistortion',
           'RandomCrop', 'RandomFlip', 'Resize']
