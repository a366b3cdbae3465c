from .evaluation import (eval_metrics, f_score, get_classes, get_palette,
                         intersect_and_union, mean_dice, mean_fscore,
                         mean_iou, pre_eval_to_metrics, total_area_to_metrics,
                         total_intersect_and_union)
from .optimizers import build_lr_schedule, build_optimizer
from .utils import add_prefix

__all__ = ['add_prefix', 'build_lr_schedule', 'build_optimizer',
           'eval_metrics', 'f_score', 'get_classes', 'get_palette',
           'intersect_and_union', 'mean_dice', 'mean_fscore', 'mean_iou',
           'pre_eval_to_metrics', 'total_area_to_metrics',
           'total_intersect_and_union']
