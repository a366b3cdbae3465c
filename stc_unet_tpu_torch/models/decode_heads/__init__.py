from .aspp_head import ASPPHead
from .carunet_head import CADRB, CARUnet, DenseASPPBlock, SKAttention
from .dc_unet_head import DC_Unet
from .decode_head import BaseDecodeHead, resolve_out_channels
from .dpt_head import (DPTHead, FeatureFusionBlock, PreActResidualConvUnit,
                       ReassembleBlocks)
from .extra_unet_heads import LinkNet, MultiResUnet, ResUNet
from .fcn_head import FCNHead
from .fpn_head import FPNHead
from .maxvit_decoder import MaxViTDecoder
from .psp_head import PSPHead
from .sep_aspp_head import DepthwiseSeparableASPPHead
from .setr_heads import SETRMLAHead, SETRUPHead, SegmenterMaskTransformerHead
from .swinunet_head import SwinUNet
from .transunet_head import TransUNet, TransUNetModule
from .unet_head import CoordAtt, UnetHead
from .unetpp_head import UnetPlusPlus
from .uper_head import UPerHead

__all__ = ['ASPPHead', 'BaseDecodeHead', 'CADRB', 'CARUnet', 'CoordAtt',
           'DC_Unet', 'DPTHead', 'DenseASPPBlock',
           'DepthwiseSeparableASPPHead', 'FCNHead', 'FPNHead',
           'FeatureFusionBlock', 'LinkNet', 'MaxViTDecoder', 'MultiResUnet',
           'PSPHead', 'PreActResidualConvUnit', 'ReassembleBlocks',
           'ResUNet', 'SETRMLAHead', 'SETRUPHead', 'SKAttention',
           'SegmenterMaskTransformerHead', 'SwinUNet', 'TransUNet',
           'TransUNetModule', 'UPerHead', 'UnetHead', 'UnetPlusPlus',
           'resolve_out_channels']
