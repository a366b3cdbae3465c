from .maxvit_encoder import MaxViT
from .resnet import ResNet, ResNetV1c, ResNetV1d
from .swin import SwinTransformer
from .unet_backbone import UnetBackbone
from .vit import VisionTransformer

__all__ = ['MaxViT', 'ResNet', 'ResNetV1c', 'ResNetV1d', 'SwinTransformer',
           'UnetBackbone', 'VisionTransformer']
