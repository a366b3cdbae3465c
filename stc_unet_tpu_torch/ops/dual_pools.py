"""Single-pass dual strip pool (P): a CUDA kernel for Hopper.

Counterpart of the CoordAtt probe's Pallas kernel,
``tools/probe_coordatt.py:100`` ``_pools_pallas`` (kernel
``_dual_pool_kernel`` at :89). The kernel is ``stc_dual_pools`` in
``csrc/dual_pools.cu``: x (N, H, W, C) → (sum over W (N, H, C), sum over H
(N, W, C)), both f32, in one read of x, with the sum over H carried down the
rows in shared memory as the TPU kernel carries it across its sequential
grid. It computes K1's function (``coordatt_fused.strip_pools``) in the TPU
probe's design; the model runs K1, and only the probe
(``stc_unet_tpu_torch/tools/probe_coordatt.py``) runs P.

On a CUDA tensor ``dual_pools`` checks its input, launches the kernel and
adds one to ``dual_pools.launches``; it raises on anything the kernel does
not take. On a CPU tensor it computes the plain version
(``dual_pools_reference``: two f32 ``torch.sum``) and counts nothing.
"""
from __future__ import annotations

import torch

from ._build import (INT, PTR, check_launch, device_type, load_kernels,
                     stream_ptr)

__all__ = ['dual_pools', 'dual_pools_reference']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {'stc_dual_pools': [PTR] * 3 + [INT] * 5 + [PTR],
               'stc_dual_pools_max_w': []}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        _lib = load_kernels('dual_pools', _SIGNATURES)
    return _lib


def dual_pools_reference(x):
    """Plain PyTorch P: ``(sum over W (N,H,C), sum over H (N,W,C))`` in
    f32."""
    return (torch.sum(x, 2, dtype=torch.float32),
            torch.sum(x, 1, dtype=torch.float32))


def _dual_pools_kernel(x):
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous float32 or bfloat16 (N, H, '
                         f'W, C) tensor, got {x.dtype} {tuple(x.shape)}')
    lib = _kernels()
    n, h, w, c = x.shape
    if n > 65535 or min(n, h, w, c) < 1 or w > lib.stc_dual_pools_max_w():
        raise ValueError(f'no kernel for x {tuple(x.shape)} (N <= 65535, W '
                         f'<= {lib.stc_dual_pools_max_w()})')
    sum_w = torch.empty((n, h, c), dtype=torch.float32, device=x.device)
    sum_h = torch.empty((n, w, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.stc_dual_pools(x.data_ptr(), sum_w.data_ptr(),
                                 sum_h.data_ptr(), _DTYPES[x.dtype], n, h, w,
                                 c, stream_ptr(x))
    check_launch(err, 'dual_pools')
    dual_pools.launches += 1
    return sum_w, sum_h


def dual_pools(x):
    """Both strip sums of x (N,H,W,C) in one pass down its rows: ``(sum over
    W -> (N,H,C), sum over H -> (N,W,C))``, both f32. Not
    differentiable."""
    if device_type(x, 'dual_pools') == 'cpu':
        return dual_pools_reference(x)
    return _dual_pools_kernel(x)


dual_pools.launches = 0
