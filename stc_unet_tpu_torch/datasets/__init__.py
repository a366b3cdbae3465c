from .builder import (DATASETS, PIPELINES, DataLoader, EpochSampler,
                      build_dataloader, build_dataset, collate)
from .custom import CustomDataset
from .my_dataset import MyDataset
from . import pipelines  # noqa: F401  (registers the transforms)

__all__ = ['DATASETS', 'PIPELINES', 'DataLoader', 'EpochSampler',
           'build_dataloader', 'build_dataset', 'collate', 'CustomDataset',
           'MyDataset']
