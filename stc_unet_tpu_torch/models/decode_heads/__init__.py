from .aspp_head import ASPPHead
from .dc_unet_head import DC_Unet
from .decode_head import BaseDecodeHead, resolve_out_channels
from .maxvit_decoder import MaxViTDecoder
from .psp_head import PSPHead
from .sep_aspp_head import DepthwiseSeparableASPPHead
from .swinunet_head import SwinUNet
from .transunet_head import TransUNet, TransUNetModule
from .unet_head import UnetHead
from .unetpp_head import UnetPlusPlus

__all__ = ['ASPPHead', 'BaseDecodeHead', 'DC_Unet',
           'DepthwiseSeparableASPPHead', 'MaxViTDecoder', 'PSPHead',
           'SwinUNet', 'TransUNet', 'TransUNetModule', 'UnetHead',
           'UnetPlusPlus', 'resolve_out_channels']
