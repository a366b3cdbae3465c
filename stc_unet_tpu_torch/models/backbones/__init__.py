from .unet_backbone import UnetBackbone

__all__ = ['UnetBackbone']
