"""stc_unet_tpu_torch: the PyTorch/CUDA port of ``stc_unet_tpu``.

A second package beside the JAX one, with the same module layout. It
imports torch and numpy and never jax or the JAX package. Models are NCHW
``nn.Module``s run in ``torch.channels_last``, with the reference fork's
``state_dict`` keys; the segmentor's public functions take and return NHWC
tensors like the JAX ones. The Pallas kernels of the JAX package become
CUDA kernels written by hand for Hopper (``csrc/``), built with ``nvcc``
at first use.

This slice covers STC-UNet inference (whole and slide) in eval mode.
"""
__version__ = '0.1.0'
