from .accuracy import Accuracy, accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy, mask_cross_entropy)
from .dice_loss import DiceLoss, binary_dice_loss, dice_loss
from .utils import (get_class_weight, reduce_loss, total_loss_from_dict,
                    weight_reduce_loss, weighted_loss)

__all__ = ['Accuracy', 'accuracy', 'CrossEntropyLoss', 'cross_entropy',
           'binary_cross_entropy', 'mask_cross_entropy', 'DiceLoss',
           'dice_loss', 'binary_dice_loss', 'get_class_weight',
           'reduce_loss', 'total_loss_from_dict', 'weight_reduce_loss',
           'weighted_loss']
