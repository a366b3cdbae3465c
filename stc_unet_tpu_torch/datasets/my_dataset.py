"""MyDataset — the author's KiTS19 2-class dataset (≙
``stc_unet_tpu/datasets/my_dataset.py``, itself the reference's
``mmseg/datasets/my_dataset.py:14``); its masks are written with the
port's PNG writer."""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from stc_unet_tpu_torch.utils import png
from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class MyDataset(CustomDataset):
    """Binary kidney-tumor segmentation: background/target, ``.png`` pairs.

    The reference fixes ``CLASSES=('background', 'target')`` and
    ``PALETTE=[[0,0,0],[1,1,1]]`` (``my_dataset.py:21-23``) — mask values are
    written as raw 0/1 so demo outputs are directly comparable to the labels.
    """

    CLASSES = ('background', 'target')
    PALETTE = [[0, 0, 0], [1, 1, 1]]

    def __init__(self, img_suffix='.png', seg_map_suffix='.png', **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)

    def results2img(self, results, imgfile_prefix, indices=None):
        """Write predicted masks as uint8 PNGs
        (reference ``my_dataset.py:44``)."""
        if indices is None:
            indices = list(range(len(self)))
        os.makedirs(imgfile_prefix, exist_ok=True)
        result_files = []
        for result, idx in zip(results, indices):
            filename = self.img_infos[idx]['filename']
            basename = osp.splitext(osp.basename(filename))[0]
            png_filename = osp.join(imgfile_prefix, f'{basename}.png')
            png.write(png_filename, np.asarray(result).astype(np.uint8))
            result_files.append(png_filename)
        return result_files

    def format_results(self, results, imgfile_prefix, indices=None, **kwargs):
        if indices is None:
            indices = list(range(len(self)))
        if not isinstance(results, list) or not isinstance(indices, list):
            raise TypeError('results and indices must be lists')
        return self.results2img(results, imgfile_prefix, indices)
