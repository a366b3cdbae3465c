"""CustomDataset (≙ ``stc_unet_tpu/datasets/custom.py``, itself the
reference's ``mmseg/datasets/custom.py:19``).

Directory-layout dataset: ``img_dir`` scan (or split file) → per-image info
dicts → pipeline. Evaluation accumulates (intersect, union, pred, label)
4-tuples per image (``pre_eval``) and reduces to aAcc/IoU/Dice/Fscore.
``load(idx, rng)`` runs the pipeline with ``rng`` (a numpy
``RandomState``) in ``results['rng']``, where the train transforms draw
from it; the train loader hands one in per sample.
"""
from __future__ import annotations

import os
import os.path as osp
import warnings
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np

from stc_unet_tpu_torch.core.evaluation import (eval_metrics,
                                                intersect_and_union,
                                                pre_eval_to_metrics)
from stc_unet_tpu_torch.utils.logger import get_root_logger, print_log
from .builder import DATASETS
from .pipelines import Compose
from .pipelines.loading import LoadAnnotations


def scandir(dir_path: str, suffix=None, recursive: bool = False):
    """Yield relative file paths under dir_path (mmcv.scandir semantics)."""
    if isinstance(suffix, str):
        suffix = (suffix,)

    def _scan(current, root):
        for entry in sorted(os.scandir(current), key=lambda e: e.name):
            if entry.is_file():
                rel = osp.relpath(entry.path, root)
                if suffix is None or rel.endswith(tuple(suffix)):
                    yield rel
            elif entry.is_dir() and recursive:
                yield from _scan(entry.path, root)

    yield from _scan(dir_path, dir_path)


@DATASETS.register_module()
class CustomDataset:
    """Semantic-seg dataset over an image/annotation directory pair.

    Layout and ctor args mirror the reference: parallel ``img_dir`` /
    ``ann_dir`` trees with ``img_suffix`` → ``seg_map_suffix`` name mapping,
    optional ``split`` file listing stems, optional custom ``classes``
    subset (→ ``label_map`` remap).
    """

    CLASSES: Optional[Sequence[str]] = None
    PALETTE = None

    def __init__(self, pipeline, img_dir, img_suffix='.jpg', ann_dir=None,
                 seg_map_suffix='.png', split=None, data_root=None,
                 test_mode=False, ignore_index=255, reduce_zero_label=False,
                 classes=None, palette=None, gt_seg_map_loader_cfg=None,
                 file_client_args=None):
        self.pipeline = Compose(pipeline)
        self.img_dir = img_dir
        self.img_suffix = img_suffix
        self.ann_dir = ann_dir
        self.seg_map_suffix = seg_map_suffix
        self.split = split
        self.data_root = data_root
        self.test_mode = test_mode
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.label_map = None
        self.CLASSES, self.PALETTE = self.get_classes_and_palette(
            classes, palette)
        self.gt_seg_map_loader = LoadAnnotations(
        ) if gt_seg_map_loader_cfg is None else LoadAnnotations(
            **gt_seg_map_loader_cfg)

        if test_mode and self.CLASSES is None:
            raise ValueError(
                '`cls.CLASSES` or `classes` should be specified when testing')

        # join paths if data_root is specified (reference custom.py:121-130)
        if self.data_root is not None:
            if not osp.isabs(self.img_dir):
                self.img_dir = osp.join(self.data_root, self.img_dir)
            if not (self.ann_dir is None or osp.isabs(self.ann_dir)):
                self.ann_dir = osp.join(self.data_root, self.ann_dir)
            if not (self.split is None or osp.isabs(self.split)):
                self.split = osp.join(self.data_root, self.split)

        self.img_infos = self.load_annotations(self.img_dir, self.img_suffix,
                                               self.ann_dir,
                                               self.seg_map_suffix, self.split)

    def __len__(self):
        return len(self.img_infos)

    def load_annotations(self, img_dir, img_suffix, ann_dir, seg_map_suffix,
                         split):
        """Scan dir / read split file → img_info list
        (reference ``custom.py:137``)."""
        img_infos = []
        if split is not None:
            with open(split) as f:
                lines = f.readlines()
            for line in lines:
                img_name = line.strip()
                img_info = dict(filename=img_name + img_suffix)
                if ann_dir is not None:
                    seg_map = img_name + seg_map_suffix
                    img_info['ann'] = dict(seg_map=seg_map)
                img_infos.append(img_info)
        else:
            for img in scandir(img_dir, img_suffix, recursive=True):
                img_info = dict(filename=img)
                if ann_dir is not None:
                    seg_map = img.replace(img_suffix, seg_map_suffix)
                    img_info['ann'] = dict(seg_map=seg_map)
                img_infos.append(img_info)
            img_infos = sorted(img_infos, key=lambda x: x['filename'])
        print_log(f'Loaded {len(img_infos)} images', logger=get_root_logger())
        return img_infos

    def get_ann_info(self, idx):
        return self.img_infos[idx]['ann']

    def pre_pipeline(self, results):
        """Seed the pipeline dict (reference ``custom.py:193``)."""
        results['seg_fields'] = []
        results['img_prefix'] = self.img_dir
        results['seg_prefix'] = self.ann_dir
        if self.custom_classes:
            results['label_map'] = self.label_map

    def __getitem__(self, idx):
        return self.load(idx)

    def load(self, idx, rng=None):
        """The pipeline's output for sample ``idx``; the train transforms
        draw from ``rng`` (and raise without one)."""
        if self.test_mode:
            return self.prepare_test_img(idx)
        return self.prepare_train_img(idx, rng)

    def prepare_train_img(self, idx, rng=None):
        img_info = self.img_infos[idx]
        ann_info = self.get_ann_info(idx)
        results = dict(img_info=img_info, ann_info=ann_info)
        if rng is not None:
            results['rng'] = rng
        self.pre_pipeline(results)
        return self.pipeline(results)

    def prepare_test_img(self, idx):
        img_info = self.img_infos[idx]
        results = dict(img_info=img_info)
        self.pre_pipeline(results)
        return self.pipeline(results)

    def format_results(self, results, imgfile_prefix, indices=None, **kwargs):
        """Placeholder for dataset-specific submission formatting."""
        raise NotImplementedError

    # -- ground truth access -------------------------------------------------
    def get_gt_seg_map_by_idx(self, index):
        ann_info = self.get_ann_info(index)
        results = dict(ann_info=ann_info)
        self.pre_pipeline(results)
        self.gt_seg_map_loader(results)
        return results['gt_semantic_seg']

    def get_gt_seg_maps(self, efficient_test=None):
        """Generator of gt seg maps for evaluation."""
        if efficient_test is not None:
            warnings.warn('efficient_test is deprecated; gt maps are '
                          'loaded lazily by default')
        for idx in range(len(self)):
            yield self.get_gt_seg_map_by_idx(idx)

    # -- evaluation ----------------------------------------------------------
    def pre_eval(self, preds, indices):
        """Per-image (intersect, union, pred, label) areas
        (reference ``custom.py:277``)."""
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]
        pre_eval_results = []
        for pred, index in zip(preds, indices):
            seg_map = self.get_gt_seg_map_by_idx(index)
            pre_eval_results.append(
                intersect_and_union(
                    pred, seg_map, len(self.CLASSES), self.ignore_index,
                    # gt maps already remapped by the loader
                    label_map=dict(),
                    reduce_zero_label=self.reduce_zero_label))
        return pre_eval_results

    def get_classes_and_palette(self, classes=None, palette=None):
        """Resolve CLASSES/PALETTE, building ``label_map`` for subsets
        (reference ``custom.py:316-386``)."""
        if classes is None:
            self.custom_classes = False
            return self.CLASSES, self.PALETTE
        self.custom_classes = True
        if isinstance(classes, str):
            with open(classes) as f:
                class_names = [line.strip() for line in f]
        elif isinstance(classes, (tuple, list)):
            class_names = classes
        else:
            raise ValueError(f'Unsupported type {type(classes)} of classes.')
        if self.CLASSES:
            if not set(class_names).issubset(self.CLASSES):
                raise ValueError('classes is not a subset of CLASSES.')
            self.label_map = {}
            for i, c in enumerate(self.CLASSES):
                if c not in class_names:
                    self.label_map[i] = 255
                else:
                    self.label_map[i] = class_names.index(c)
        palette = self.get_palette_for_custom_classes(class_names, palette)
        return class_names, palette

    def get_palette_for_custom_classes(self, class_names, palette=None):
        if self.label_map is not None:
            palette = []
            for old_id, new_id in sorted(self.label_map.items(),
                                         key=lambda x: x[1]):
                if new_id != 255:
                    palette.append(self.PALETTE[old_id])
            palette = type(self.PALETTE)(palette)
        elif palette is None:
            if self.PALETTE is None:
                rng = np.random.RandomState(42)
                palette = rng.randint(0, 255, size=(len(class_names), 3))
            else:
                palette = self.PALETTE
        return palette

    def evaluate(self, results, metric='mIoU', logger=None, gt_seg_maps=None,
                 **kwargs):
        """Reduce results to a metric table (reference ``custom.py:388-487``).

        ``results`` may be raw seg maps (list of (H, W) arrays) or
        accumulated ``pre_eval`` 4-tuples.
        """
        if isinstance(metric, str):
            metric = [metric]
        allowed_metrics = ['mIoU', 'mDice', 'mFscore']
        if not set(metric).issubset(set(allowed_metrics)):
            raise KeyError(f'metric {metric} is not supported')

        eval_results = {}
        # distinguish raw-result and pre-eval paths
        if np.all([isinstance(r, tuple) and len(r) == 4 and
                   np.asarray(r[0]).ndim == 1 for r in results]):
            ret_metrics = pre_eval_to_metrics(results, metric)
        else:
            if gt_seg_maps is None:
                gt_seg_maps = self.get_gt_seg_maps()
            num_classes = len(self.CLASSES)
            ret_metrics = eval_metrics(
                results, gt_seg_maps, num_classes, self.ignore_index, metric,
                label_map=dict(), reduce_zero_label=self.reduce_zero_label)

        class_names = self.CLASSES

        # summary table (means over classes)
        ret_metrics_summary = OrderedDict({
            m: np.round(np.nanmean(v) * 100, 2)
            for m, v in ret_metrics.items()
        })
        # per-class table
        ret_metrics.pop('aAcc', None)
        ret_metrics_class = OrderedDict({
            m: np.round(v * 100, 2) for m, v in ret_metrics.items()
        })
        ret_metrics_class.update({'Class': class_names})
        ret_metrics_class.move_to_end('Class', last=False)

        def _table(rows: Dict[str, Sequence]) -> str:
            keys = list(rows)
            cols = [[str(k)] + [str(x) for x in np.atleast_1d(rows[k])]
                    for k in keys]
            widths = [max(len(c) for c in col) for col in cols]
            lines = []
            header = ' | '.join(c[0].ljust(w) for c, w in zip(cols, widths))
            lines.append(header)
            lines.append('-+-'.join('-' * w for w in widths))
            nrows = max(len(c) - 1 for c in cols)
            for r in range(1, nrows + 1):
                lines.append(' | '.join(
                    (c[r] if r < len(c) else '').ljust(w)
                    for c, w in zip(cols, widths)))
            return '\n'.join(lines)

        print_log('per class results:', logger)
        print_log('\n' + _table(ret_metrics_class), logger=logger)
        print_log('Summary:', logger)
        print_log('\n' + _table(ret_metrics_summary), logger=logger)

        # flat eval_results dict (reference custom.py:471-487)
        for key, value in ret_metrics_summary.items():
            if key == 'aAcc':
                eval_results[key] = value / 100.0
            else:
                eval_results['m' + key] = value / 100.0
        for key, value in ret_metrics_class.items():
            if key == 'Class':
                continue
            eval_results.update({
                key + '.' + str(name): value[idx] / 100.0
                for idx, name in enumerate(class_names)
            })
        return eval_results
