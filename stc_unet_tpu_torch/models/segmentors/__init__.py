from .base import BaseSegmentor
from .encoder_decoder import EncoderDecoder
from .encoder_decoder_full import EncoderDecoderFull, IdentityBackbone

__all__ = ['BaseSegmentor', 'EncoderDecoder', 'EncoderDecoderFull',
           'IdentityBackbone']
