from .builder import (DATASETS, PIPELINES, DataLoader, EpochSampler,
                      build_dataloader, build_dataset, collate,
                      inject_img_cache, sample_seed)
from .custom import CustomDataset
from .device_pipeline import (DeviceBatchLoader, make_device_train_pipeline,
                              split_train_pipeline,
                              wrap_loader_with_device_pipeline)
from .my_dataset import MyDataset
from . import pipelines  # noqa: F401  (registers the transforms)
from .pipelines import DeviceFormatBundle
from .samplers import DistributedSampler

__all__ = ['DATASETS', 'PIPELINES', 'DataLoader', 'DeviceBatchLoader',
           'DeviceFormatBundle', 'DistributedSampler', 'EpochSampler',
           'build_dataloader', 'build_dataset', 'collate', 'inject_img_cache',
           'make_device_train_pipeline', 'sample_seed',
           'split_train_pipeline', 'wrap_loader_with_device_pipeline',
           'CustomDataset', 'MyDataset']
