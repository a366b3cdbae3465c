from .inference import init_segmentor

__all__ = ['init_segmentor']
