from .decode_head import BaseDecodeHead, resolve_out_channels
from .unet_head import UnetHead

__all__ = ['BaseDecodeHead', 'UnetHead', 'resolve_out_channels']
