from .aspp_head import ASPPHead
from .carunet_head import CADRB, CARUnet, DenseASPPBlock, SKAttention
from .dc_unet_head import DC_Unet
from .decode_head import BaseDecodeHead, resolve_out_channels
from .extra_unet_heads import LinkNet, MultiResUnet, ResUNet
from .maxvit_decoder import MaxViTDecoder
from .psp_head import PSPHead
from .sep_aspp_head import DepthwiseSeparableASPPHead
from .swinunet_head import SwinUNet
from .transunet_head import TransUNet, TransUNetModule
from .unet_head import CoordAtt, UnetHead
from .unetpp_head import UnetPlusPlus

__all__ = ['ASPPHead', 'BaseDecodeHead', 'CADRB', 'CARUnet', 'CoordAtt',
           'DC_Unet', 'DenseASPPBlock', 'DepthwiseSeparableASPPHead',
           'LinkNet', 'MaxViTDecoder', 'MultiResUnet', 'PSPHead', 'ResUNet',
           'SKAttention', 'SwinUNet', 'TransUNet', 'TransUNetModule',
           'UnetHead', 'UnetPlusPlus', 'resolve_out_channels']
