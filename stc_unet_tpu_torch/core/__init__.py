from .optimizers import build_lr_schedule, build_optimizer
from .utils import add_prefix

__all__ = ['add_prefix', 'build_lr_schedule', 'build_optimizer']
