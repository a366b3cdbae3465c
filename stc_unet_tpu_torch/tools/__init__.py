"""Measurement scripts of the port (``python -m
stc_unet_tpu_torch.tools.<name>``)."""
