from .class_names import get_classes, get_palette
from .metrics import (eval_metrics, f_score, intersect_and_union, mean_dice,
                      mean_fscore, mean_iou, pre_eval_to_metrics,
                      total_area_to_metrics, total_intersect_and_union)

__all__ = ['get_classes', 'get_palette', 'eval_metrics', 'f_score',
           'intersect_and_union', 'mean_dice', 'mean_fscore', 'mean_iou',
           'pre_eval_to_metrics', 'total_area_to_metrics',
           'total_intersect_and_union']
