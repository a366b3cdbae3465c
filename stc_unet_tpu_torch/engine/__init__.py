from .checkpoint import load_checkpoint, load_checkpoint_file
from .train_state import make_train_step, make_val_step, total_loss_from_dict

__all__ = ['load_checkpoint', 'load_checkpoint_file', 'make_train_step',
           'make_val_step', 'total_loss_from_dict']
