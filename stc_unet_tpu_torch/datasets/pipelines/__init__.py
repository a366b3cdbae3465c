from .compose import Compose
from .formatting import Collect, ImageToTensor
from .loading import LoadAnnotations, LoadImage, LoadImageFromFile
from .test_time_aug import MultiScaleFlipAug
from .transforms import Normalize, RandomFlip, Resize

__all__ = ['Compose', 'Collect', 'ImageToTensor', 'LoadAnnotations',
           'LoadImage', 'LoadImageFromFile', 'MultiScaleFlipAug',
           'Normalize', 'RandomFlip', 'Resize']
