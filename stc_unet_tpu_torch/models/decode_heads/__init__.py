from .decode_head import BaseDecodeHead, resolve_out_channels
from .maxvit_decoder import MaxViTDecoder
from .unet_head import UnetHead

__all__ = ['BaseDecodeHead', 'MaxViTDecoder', 'UnetHead',
           'resolve_out_channels']
