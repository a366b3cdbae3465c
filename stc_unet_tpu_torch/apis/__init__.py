from .inference import inference_segmentor, init_segmentor
from .test import multi_gpu_test, single_gpu_test
from .train import (init_random_seed, set_random_seed, train_device,
                    train_segmentor)

__all__ = ['inference_segmentor', 'init_segmentor', 'init_random_seed',
           'multi_gpu_test', 'set_random_seed', 'single_gpu_test',
           'train_device', 'train_segmentor']
