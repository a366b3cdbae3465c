"""stc_unet_tpu_torch: the PyTorch/CUDA port of ``stc_unet_tpu``.

A second package beside the JAX one, with the same module layout. It
imports torch and numpy and never jax or the JAX package. Models are NCHW
``nn.Module``s run in ``torch.channels_last``, with the reference fork's
``state_dict`` keys; the segmentor's public functions take and return NHWC
tensors like the JAX ones. The Pallas kernels of the JAX package become
CUDA kernels written by hand for Hopper (``csrc/``), built with ``nvcc``
at first use.

It covers STC-UNet and MaxViT-UNet inference (whole and slide) and
their train step; the test path: the PNG test pipeline (the port reads and
writes PNG and msgpack itself: the card's machine has neither cv2, Pillow
nor msgpack), ``inference_segmentor``, ``single_gpu_test`` and the metrics;
and weights from a JAX ``.ckpt`` or a fork ``.pth``.
"""
__version__ = '0.1.0'
