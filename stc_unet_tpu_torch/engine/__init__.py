from .train_state import make_train_step, make_val_step, total_loss_from_dict

__all__ = ['make_train_step', 'make_val_step', 'total_loss_from_dict']
