from .coordatt_fused import (gate_add, gate_add_reference, strip_pools,
                             strip_pools_reference)
from .wrappers import Upsample, resize

__all__ = ['resize', 'Upsample', 'strip_pools', 'gate_add',
           'strip_pools_reference', 'gate_add_reference']
