from .coordatt_fused import (gate_add, gate_add_reference, gate_dots,
                             gate_dots_reference, strip_pools,
                             strip_pools_reference)
from .flash_attention import (flash_attention, flash_attention_backward,
                              flash_attention_backward_reference,
                              flash_attention_reference)
from .wrappers import Upsample, resize

__all__ = ['resize', 'Upsample', 'strip_pools', 'gate_add', 'gate_dots',
           'strip_pools_reference', 'gate_add_reference',
           'gate_dots_reference', 'flash_attention',
           'flash_attention_backward', 'flash_attention_reference',
           'flash_attention_backward_reference']
