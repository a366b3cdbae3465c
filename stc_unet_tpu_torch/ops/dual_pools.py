"""Single-pass dual strip pool (P): a CUDA kernel for Hopper.

Counterpart of the CoordAtt probe's Pallas kernel,
``tools/probe_coordatt.py:100`` ``_pools_pallas`` (kernel
``_dual_pool_kernel`` at :89). The kernel is ``stc_dual_pools`` in
``csrc/dual_pools.cu``: x (N, H, W, C) → (sum over W (N, H, C), sum over H
(N, W, C)), both f32, in one launch that reads x once. Bands of at most 64
rows run in parallel, and their column sums are added inside the same
launch: through distributed shared memory in a thread-block cluster, or by
the band block that finishes last (``dual_plan`` picks, from the shape).
It computes K1's function (``coordatt_fused.strip_pools``) with code of its
own; the model runs K1, and only the probe
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

__all__ = ['dual_pools', 'dual_pools_reference', 'dual_plan']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# P's geometry (csrc/dual_pools.cu): lanes a worker (8 vectors of 16
# bytes), workers (rows) a warp, warps a block, floats of a warp's column
# partials a chunk, chunks a run of the sum over W, bands a cluster
_LANES, _SLOTS, _MAX_WARPS = 8, 4, 16
_CHUNK_FLOATS, _RUN_CHUNKS, _MAX_CLUSTER = 1024, 32, 8
_MAX_BLOCKS = 2 ** 31 - 1
# how the bands' column sums meet: the C side's `combine`
_COMBINE = {'one_band': 0, 'cluster': 1, 'last': 2}
_SIGNATURES = {'stc_dual_pools': [PTR] * 5 + [INT] * 9 + [PTR],
               'stc_dual_pools_clusters': [INT] * 4 + [PTR]}
_lib = None
_counters = {}


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


def dual_plan(shape, itemsize, aligned, combine=None):
    """P's launch on x (N, H, W, C), from the shape, the element size and
    whether x is 16-byte aligned; the outputs and the scratch, fresh from
    the caching allocator, are.

    ``vec``: 16-byte vectors (``width`` elements a lane) where C is a
    multiple of a channel tile of 8 vectors (64 bfloat16 or 32 floats) and
    x is aligned, else one element a lane (``width`` 1, tiles of 8
    channels). ``warps`` a block (up to 16; fewer when H is short), each
    block one of ``bands`` bands of ``4 * warps`` rows and one of ``tiles``
    channel tiles; ``blocks`` in all, at most 2^31 - 1. ``chunk``: pixels
    of W a chunk of the column partials (and of the row sums' first
    level), ``run``: chunks a run of the row sums. ``combine``: how the
    bands' column sums meet, ``'one_band'`` where H is one band, else
    ``'cluster'`` (the bands of one (image, tile) in a cluster of
    ``cluster`` blocks, at most 8) or ``'last'`` (the last band block adds
    them from a scratch of ``scratch`` f32, with ``counters`` counters).
    ``combine`` None takes the default for the shape; a combine that the
    shape does not allow raises.
    """
    n, h, w, c = shape
    if min(shape) < 1:
        raise ValueError(f'no kernel for x {tuple(shape)}')
    per_vec = 16 // itemsize
    vec = bool(aligned) and c % (_LANES * per_vec) == 0
    width = per_vec if vec else 1
    tile = _LANES * width
    warps = min(_MAX_WARPS, -(-h // _SLOTS))
    bands = -(-h // (warps * _SLOTS))
    tiles = -(-c // tile)
    blocks = n * tiles * bands
    if blocks > _MAX_BLOCKS:
        raise ValueError(f'no kernel for x {tuple(shape)}: {blocks} blocks, '
                         f'past the 2^31 - 1 of a grid')
    if combine is None:
        combine = ('one_band' if bands == 1 else
                   'cluster' if bands <= _MAX_CLUSTER else 'last')
    if combine not in _COMBINE or (combine == 'one_band') != (bands == 1) or \
            (combine == 'cluster' and bands > _MAX_CLUSTER):
        raise ValueError(f'combine {combine!r} does not take {bands} bands')
    last = combine == 'last'
    return dict(vec=int(vec), width=width, warps=warps, bands=bands,
                tiles=tiles, blocks=blocks,
                chunk=min(_CHUNK_FLOATS // tile, 32), run=_RUN_CHUNKS,
                combine=combine,
                cluster=bands if combine == 'cluster' else 0,
                scratch=n * tiles * bands * w * tile if last else 0,
                counters=n * tiles if last else 0)


def _counter_buffer(x, count):
    """At least ``count`` zeroed int32 counters for the last-block combine
    on x's device and stream, zeroed once when allocated: every launch
    leaves them zero."""
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < count:
        buf = _counters[key] = torch.zeros(count, dtype=torch.int32,
                                           device=x.device)
    return buf


def _dual_pools_kernel(x, combine=None):
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous float32 or bfloat16 (N, H, '
                         f'W, C) tensor, got {x.dtype} {tuple(x.shape)}')
    n, h, w, c = x.shape
    plan = dual_plan(x.shape, x.element_size(), x.data_ptr() % 16 == 0,
                     combine)
    lib = _kernels()
    sum_w = torch.empty((n, h, c), dtype=torch.float32, device=x.device)
    sum_h = torch.empty((n, w, c), dtype=torch.float32, device=x.device)
    scratch = counters = None
    if plan['combine'] == 'last':
        scratch = torch.empty(plan['scratch'], dtype=torch.float32,
                              device=x.device)
        counters = _counter_buffer(x, plan['counters'])
    with torch.cuda.device(x.device):
        err = lib.stc_dual_pools(
            x.data_ptr(), sum_w.data_ptr(), sum_h.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _DTYPES[x.dtype], plan['vec'], plan['warps'], plan['bands'],
            _COMBINE[plan['combine']], n, h, w, c, stream_ptr(x))
    check_launch(err, 'dual_pools')
    dual_pools.launches += 1
    return sum_w, sum_h


def dual_pools(x):
    """Both strip sums of x (N,H,W,C) in one launch that reads x once:
    ``(sum over W -> (N,H,C), sum over H -> (N,W,C))``, both f32. Not
    differentiable."""
    if device_type(x, 'dual_pools') == 'cpu':
        return dual_pools_reference(x)
    return _dual_pools_kernel(x)


dual_pools.launches = 0
