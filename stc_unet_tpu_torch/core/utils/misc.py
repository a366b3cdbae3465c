"""Small helpers (≙ ``stc_unet_tpu/core/utils/misc.py``)."""


def add_prefix(inputs: dict, prefix: str) -> dict:
    """Namespace a loss dict: ``{'loss_ce': v}`` → ``{'decode.loss_ce': v}``."""
    return {f'{prefix}.{name}': value for name, value in inputs.items()}
