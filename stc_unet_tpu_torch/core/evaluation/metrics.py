"""Segmentation evaluation metrics (the port's copy of
``stc_unet_tpu/core/evaluation/metrics.py``, itself ≙ the reference's
``mmseg/core/evaluation/metrics.py``).

Host-side numpy implementation of the histogram-based metric stack:
``intersect_and_union`` (reference ``metrics.py:26-87``) accumulates per-class
(intersect, union, pred, label) areas; ``eval_metrics`` /
``pre_eval_to_metrics`` / ``total_area_to_metrics`` (reference
``metrics.py:257,309,387``) turn accumulated areas into aAcc/IoU/Acc/Dice/
Fscore/Precision/Recall.

Defect policy (SURVEY.md §2.7): the fork's ``metrics.py`` injects a random
module-level constant into an "ASD" pseudo-metric and inflates every value via
``value + (1 - value) / 3`` (reference ``metrics.py:7,427-428,454-457``).
These are bugs (they contradict the repo's own ``tests/test_metrics.py``);
this module implements the standard upstream math.

numpy (not jnp) on purpose: eval accumulates over thousands of variable-size
label maps on host — bincount on CPU beats device round-trips.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, str):
        # lazy-load path parity with the reference (mmcv.imread of a png)
        from stc_unet_tpu_torch.datasets.pipelines.loading import \
            imread_annotation
        return imread_annotation(x)
    return np.asarray(x)


def intersect_and_union(pred_label,
                        label,
                        num_classes: int,
                        ignore_index: int,
                        label_map: Optional[dict] = None,
                        reduce_zero_label: bool = False):
    """Per-image per-class areas (reference ``metrics.py:26-87``).

    Returns (area_intersect, area_union, area_pred_label, area_label),
    each an int64 array of shape (num_classes,).
    """
    pred_label = _as_numpy(pred_label)
    label = _as_numpy(label).copy()

    if label_map:
        label_remapped = label.copy()
        for old_id, new_id in label_map.items():
            label_remapped[label == old_id] = new_id
        label = label_remapped
    if reduce_zero_label:
        label[label == 0] = 255
        label = label - 1
        label[label == 254] = 255

    mask = label != ignore_index
    pred_label = pred_label[mask].astype(np.int64)
    label = label[mask].astype(np.int64)

    intersect = pred_label[pred_label == label]
    area_intersect = np.bincount(intersect, minlength=num_classes)[:num_classes]
    area_pred_label = np.bincount(pred_label, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    area_union = area_pred_label + area_label - area_intersect
    return area_intersect, area_union, area_pred_label, area_label


def total_intersect_and_union(results,
                              gt_seg_maps,
                              num_classes: int,
                              ignore_index: int,
                              label_map: Optional[dict] = None,
                              reduce_zero_label: bool = False):
    """Accumulate :func:`intersect_and_union` over a result list
    (reference ``metrics.py:90-135``)."""
    total_area_intersect = np.zeros((num_classes,), np.float64)
    total_area_union = np.zeros((num_classes,), np.float64)
    total_area_pred_label = np.zeros((num_classes,), np.float64)
    total_area_label = np.zeros((num_classes,), np.float64)
    for result, gt_seg_map in zip(results, gt_seg_maps):
        a_i, a_u, a_p, a_l = intersect_and_union(
            result, gt_seg_map, num_classes, ignore_index, label_map,
            reduce_zero_label)
        total_area_intersect += a_i
        total_area_union += a_u
        total_area_pred_label += a_p
        total_area_label += a_l
    return (total_area_intersect, total_area_union, total_area_pred_label,
            total_area_label)


def mean_iou(results, gt_seg_maps, num_classes, ignore_index,
             nan_to_num=None, label_map=None, reduce_zero_label=False):
    """aAcc/IoU/Acc (reference ``metrics.py:138-174``)."""
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        metrics=['mIoU'], nan_to_num=nan_to_num,
                        label_map=label_map,
                        reduce_zero_label=reduce_zero_label)


def mean_dice(results, gt_seg_maps, num_classes, ignore_index,
              nan_to_num=None, label_map=None, reduce_zero_label=False):
    """aAcc/Dice/Acc (reference ``metrics.py:177-214``)."""
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        metrics=['mDice'], nan_to_num=nan_to_num,
                        label_map=label_map,
                        reduce_zero_label=reduce_zero_label)


def mean_fscore(results, gt_seg_maps, num_classes, ignore_index,
                nan_to_num=None, label_map=None, reduce_zero_label=False,
                beta=1):
    """aAcc/Fscore/Precision/Recall (reference ``metrics.py:217-254``)."""
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        metrics=['mFscore'], nan_to_num=nan_to_num,
                        label_map=label_map,
                        reduce_zero_label=reduce_zero_label, beta=beta)


def eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                 metrics: Union[str, Sequence[str]] = ['mIoU'],
                 nan_to_num=None, label_map=None, reduce_zero_label=False,
                 beta=1):
    """Metrics from raw (pred, gt) lists (reference ``metrics.py:257-306``)."""
    total_areas = total_intersect_and_union(
        results, gt_seg_maps, num_classes, ignore_index, label_map,
        reduce_zero_label)
    return total_area_to_metrics(*total_areas, metrics=metrics,
                                 nan_to_num=nan_to_num, beta=beta)


def pre_eval_to_metrics(pre_eval_results,
                        metrics: Union[str, Sequence[str]] = ['mIoU'],
                        nan_to_num=None, beta=1):
    """Metrics from accumulated ``pre_eval`` 4-tuples
    (reference ``metrics.py:309-341``)."""
    pre_eval_results = tuple(zip(*pre_eval_results))
    assert len(pre_eval_results) == 4
    total_area_intersect = np.sum(
        [np.asarray(x, np.float64) for x in pre_eval_results[0]], axis=0)
    total_area_union = np.sum(
        [np.asarray(x, np.float64) for x in pre_eval_results[1]], axis=0)
    total_area_pred_label = np.sum(
        [np.asarray(x, np.float64) for x in pre_eval_results[2]], axis=0)
    total_area_label = np.sum(
        [np.asarray(x, np.float64) for x in pre_eval_results[3]], axis=0)
    return total_area_to_metrics(total_area_intersect, total_area_union,
                                 total_area_pred_label, total_area_label,
                                 metrics=metrics, nan_to_num=nan_to_num,
                                 beta=beta)


def total_area_to_metrics(total_area_intersect, total_area_union,
                          total_area_pred_label, total_area_label,
                          metrics: Union[str, Sequence[str]] = ['mIoU'],
                          nan_to_num=None, beta=1) -> Dict[str, np.ndarray]:
    """Areas → metric dict (reference ``metrics.py:387-460``, standard math).

    Returns an OrderedDict: ``aAcc`` scalar plus per-class arrays for each
    requested metric (``IoU``/``Acc`` for mIoU, ``Dice``/``Acc`` for mDice,
    ``Fscore``/``Precision``/``Recall`` for mFscore).
    """
    if isinstance(metrics, str):
        metrics = [metrics]
    allowed_metrics = ['mIoU', 'mDice', 'mFscore']
    if not set(metrics).issubset(set(allowed_metrics)):
        raise KeyError(f'metrics {metrics} is not supported')

    with np.errstate(divide='ignore', invalid='ignore'):
        all_acc = total_area_intersect.sum() / total_area_label.sum()
        ret_metrics = OrderedDict({'aAcc': all_acc})
        for metric in metrics:
            if metric == 'mIoU':
                iou = total_area_intersect / total_area_union
                acc = total_area_intersect / total_area_label
                ret_metrics['IoU'] = iou
                ret_metrics['Acc'] = acc
            elif metric == 'mDice':
                dice = 2 * total_area_intersect / (
                    total_area_pred_label + total_area_label)
                acc = total_area_intersect / total_area_label
                ret_metrics['Dice'] = dice
                ret_metrics['Acc'] = acc
            elif metric == 'mFscore':
                precision = total_area_intersect / total_area_pred_label
                recall = total_area_intersect / total_area_label
                f_value = np.array([
                    f_score(p, r, beta) for p, r in zip(precision, recall)])
                ret_metrics['Fscore'] = f_value
                ret_metrics['Precision'] = precision
                ret_metrics['Recall'] = recall

    ret_metrics = {
        metric: np.asarray(value, np.float64)
        for metric, value in ret_metrics.items()
    }
    if nan_to_num is not None:
        ret_metrics = OrderedDict({
            metric: np.nan_to_num(value, nan=nan_to_num)
            for metric, value in ret_metrics.items()
        })
    return ret_metrics


def f_score(precision, recall, beta=1):
    """F-beta (reference ``metrics.py:10-23``)."""
    score = (1 + beta**2) * (precision * recall) / (
        (beta**2 * precision) + recall)
    return score
