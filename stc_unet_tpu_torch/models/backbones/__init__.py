from .maxvit_encoder import MaxViT
from .unet_backbone import UnetBackbone

__all__ = ['MaxViT', 'UnetBackbone']
