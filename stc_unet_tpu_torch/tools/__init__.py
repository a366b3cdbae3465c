"""The port's train CLI and measurement scripts (``python -m
stc_unet_tpu_torch.tools.<name>``)."""
