from .builder import (DATASETS, PIPELINES, DataLoader, EpochSampler,
                      build_dataloader, build_dataset, collate,
                      inject_img_cache, sample_seed)
from .custom import CustomDataset
from .my_dataset import MyDataset
from . import pipelines  # noqa: F401  (registers the transforms)
from .samplers import DistributedSampler

__all__ = ['DATASETS', 'PIPELINES', 'DataLoader', 'DistributedSampler',
           'EpochSampler', 'build_dataloader', 'build_dataset', 'collate',
           'inject_img_cache', 'sample_seed', 'CustomDataset', 'MyDataset']
