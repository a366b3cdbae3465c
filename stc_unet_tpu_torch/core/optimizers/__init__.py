from .builder import RMSprop, build_optimizer
from .lr_schedules import build_lr_schedule

__all__ = ['RMSprop', 'build_lr_schedule', 'build_optimizer']
