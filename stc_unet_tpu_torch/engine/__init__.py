from .checkpoint import (find_latest_checkpoint, load_checkpoint,
                         load_checkpoint_file, load_opt_state,
                         save_checkpoint)
from .eval_hooks import DistEvalHook, EvalHook
from .extra_hooks import MMSegWandbHook, TorchProfilerHook
from .hooks import (HOOKS, CheckpointHook, DistSamplerSeedHook, Hook,
                    IterTimerHook, LogBuffer, TensorboardLoggerHook,
                    TextLoggerHook, get_priority)
from .runner import (RUNNERS, BaseRunner, EpochBasedRunner, IterBasedRunner,
                     build_runner)
from .train_state import make_train_step, make_val_step, total_loss_from_dict

__all__ = ['find_latest_checkpoint', 'load_checkpoint', 'load_checkpoint_file',
           'load_opt_state', 'save_checkpoint', 'DistEvalHook', 'EvalHook',
           'MMSegWandbHook', 'TorchProfilerHook', 'HOOKS',
           'CheckpointHook', 'DistSamplerSeedHook', 'Hook', 'IterTimerHook',
           'LogBuffer', 'TensorboardLoggerHook', 'TextLoggerHook',
           'get_priority', 'RUNNERS', 'BaseRunner', 'EpochBasedRunner',
           'IterBasedRunner', 'build_runner', 'make_train_step',
           'make_val_step', 'total_loss_from_dict']
