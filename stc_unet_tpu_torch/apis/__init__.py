from .inference import inference_segmentor, init_segmentor
from .test import single_gpu_test

__all__ = ['inference_segmentor', 'init_segmentor', 'single_gpu_test']
