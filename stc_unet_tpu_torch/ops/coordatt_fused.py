"""CoordAtt strip pools (K1), gate add (K2) and its backward (K2b): CUDA
kernels for Hopper.

Counterpart of ``stc_unet_tpu/ops/coordatt_fused.py``. The kernels are in
``csrc/coordatt_fused.cu`` and replace the Pallas kernels there:

- ``strip_pools`` (K1) ← ``_pools_call``/``_pools_kernel``: x (N,H,W,C) →
  (sum over W (N,H,C), sum over H (N,W,C)), both f32, in one read of x.
- ``gate_add`` (K2) ← ``_gate_add_call``/``_gate_add_kernel``:
  ``a_h[:, :, None, :] * a_w[:, None, :, :] + x`` in one read and one write
  of x.
- ``gate_dots`` (K2b) ← ``_gate_dots_call``/``_gate_dots_kernel``, the
  backward of ``gate_add``: do (N,H,W,C) → (sum over W of do·a_w (N,H,C),
  sum over H of do·a_h (N,W,C)), both f32, in one read of do.

All three are bound by memory bytes on the card: the least time is the
bytes they must move over the 3.35 TB/s of an H100 SXM (K1: x once plus the
two small outputs; K2: x and out, plus a_h and a_w; K2b: do once plus a_h,
a_w and the two small outputs). The source says what each design does
about that bound.

On a CUDA tensor each wrapper checks its inputs, launches its kernel and
adds one to its ``launches`` count; it raises on anything the kernel does
not take. On a CPU tensor it computes the plain PyTorch version
(``strip_pools_reference``, ``gate_add_reference``,
``gate_dots_reference``) and counts nothing. ``gate_add``'s autograd
backward is ``gate_dots``, so a backward on the card launches K2b.

Unlike the JAX package, which keeps its Pallas kernels off in the model
(their TPU layout boundary costs more than they save), the port's CoordAtt
always goes through these wrappers: on the card they are the eval path.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, check_launch, load_kernels, stream_ptr

__all__ = ['strip_pools', 'gate_add', 'gate_dots', 'strip_pools_reference',
           'gate_add_reference', 'gate_dots_reference']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_BAND_ROWS = 64   # rows per block of K1's and K2b's first pass (kPoolBand)
_lib = None


_SIGNATURES = {
    'stc_strip_pools': [PTR] * 4 + [INT] * 6 + [PTR],
    'stc_gate_add': [PTR] * 4 + [INT] * 6 + [PTR],
    'stc_gate_dots': [PTR] * 6 + [INT] * 6 + [PTR],
}


def _kernels():
    global _lib
    if _lib is None:
        _lib = load_kernels('coordatt_fused', _SIGNATURES)
    return _lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous (NHWC)')


def _check_x(x):
    if x.ndim != 4:
        raise ValueError(f'x must be (N, H, W, C), got {tuple(x.shape)}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    _check('x', x, x.shape, x.dtype, x.device)
    n, h, w, c = x.shape
    if n > 65535 or min(n, h, w, c) < 1:
        raise ValueError(f'unsupported shape {tuple(x.shape)}')


# ---------------------------------------------------------------------------
# K1: strip_pools
# ---------------------------------------------------------------------------

def strip_pools_reference(x):
    """Plain PyTorch K1: ``(sum_w (N,H,C), sum_h (N,W,C))`` in f32."""
    xf = x.float()
    return xf.sum(2), xf.sum(1)


def _strip_outputs(x):
    """The two f32 strip outputs of K1/K2b, (N,H,C) and (N,W,C), their band
    count and the (N, bands, W, C) f32 scratch of the first pass."""
    n, h, w, c = x.shape
    rows = torch.empty((n, h, c), dtype=torch.float32, device=x.device)
    cols = torch.empty((n, w, c), dtype=torch.float32, device=x.device)
    bands = -(-h // _POOL_BAND_ROWS)
    scratch = (torch.empty((n, bands, w, c), dtype=torch.float32,
                           device=x.device) if bands > 1 else cols)
    return rows, cols, bands, scratch


def _strip_pools_kernel(x):
    _check_x(x)
    lib = _kernels()
    n, h, w, c = x.shape
    sum_w, sum_h, bands, scratch = _strip_outputs(x)
    with torch.cuda.device(x.device):
        err = lib.stc_strip_pools(x.data_ptr(), sum_w.data_ptr(),
                                  sum_h.data_ptr(), scratch.data_ptr(),
                                  _DTYPES[x.dtype], bands, n, h, w, c,
                                  stream_ptr(x))
    check_launch(err, 'strip_pools')
    strip_pools.launches += 1
    return sum_w, sum_h


class _StripPools(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.x_dtype = x.dtype
        return _strip_pools_kernel(x)

    @staticmethod
    def backward(ctx, g_w, g_h):
        # the JAX VJP (_strip_pools_bwd) is a plain broadcast add too
        dx = g_w[:, :, None, :] + g_h[:, None, :, :]
        return dx.to(ctx.x_dtype)


def strip_pools(x):
    """Both CoordAtt strip sums of x (N,H,W,C) in one read of x.

    Returns ``(sum over W -> (N,H,C), sum over H -> (N,W,C))``, both f32.
    """
    if x.device.type == 'cpu':
        return strip_pools_reference(x)
    if x.device.type != 'cuda':
        raise ValueError(f'strip_pools: no kernel for device {x.device}')
    return _StripPools.apply(x)


strip_pools.launches = 0


# ---------------------------------------------------------------------------
# K2: gate_add
# ---------------------------------------------------------------------------

def gate_add_reference(x, a_h, a_w):
    """Plain PyTorch K2: ``a_h[:, :, None, :] * a_w[:, None, :, :] + x``."""
    return a_h[:, :, None, :] * a_w[:, None, :, :] + x


def _gate_add_kernel(x, a_h, a_w):
    _check_x(x)
    n, h, w, c = x.shape
    _check('a_h', a_h, (n, h, c), x.dtype, x.device)
    _check('a_w', a_w, (n, w, c), x.dtype, x.device)
    lib = _kernels()
    out = torch.empty_like(x)
    per_vec = 16 // x.element_size()
    vec = int(c % per_vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, a_h, a_w, out)))
    with torch.cuda.device(x.device):
        err = lib.stc_gate_add(x.data_ptr(), a_h.data_ptr(), a_w.data_ptr(),
                               out.data_ptr(), _DTYPES[x.dtype], vec, n, h,
                               w, c, stream_ptr(x))
    check_launch(err, 'gate_add')
    gate_add.launches += 1
    return out


class _GateAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a_h, a_w):
        ctx.save_for_backward(a_h, a_w)
        return _gate_add_kernel(x, a_h, a_w)

    @staticmethod
    def backward(ctx, grad_out):
        # JAX _gate_add_bwd: dx is do itself; dh, dw from K2b, cast once
        a_h, a_w = ctx.saved_tensors
        dh, dw = gate_dots(grad_out.contiguous(), a_h, a_w)
        return grad_out, dh.to(a_h.dtype), dw.to(a_w.dtype)


def gate_add(x, a_h, a_w):
    """``a_h[:, :, None, :] * a_w[:, None, :, :] + x`` in one read and one
    write of x (N,H,W,C); a_h (N,H,C) and a_w (N,W,C) in x's dtype."""
    if x.device.type == 'cpu':
        return gate_add_reference(x, a_h, a_w)
    if x.device.type != 'cuda':
        raise ValueError(f'gate_add: no kernel for device {x.device}')
    return _GateAdd.apply(x, a_h, a_w)


gate_add.launches = 0


# ---------------------------------------------------------------------------
# K2b: gate_dots, the backward of gate_add
# ---------------------------------------------------------------------------

def gate_dots_reference(do, a_h, a_w):
    """Plain PyTorch K2b: ``(sum_w f32(do)·f32(a_w) (N,H,C), sum_h
    f32(do)·f32(a_h) (N,W,C))``."""
    dof = do.float()
    return ((dof * a_w.float()[:, None]).sum(2),
            (dof * a_h.float()[:, :, None]).sum(1))


def _gate_dots_kernel(do, a_h, a_w):
    _check_x(do)
    n, h, w, c = do.shape
    _check('a_h', a_h, (n, h, c), do.dtype, do.device)
    _check('a_w', a_w, (n, w, c), do.dtype, do.device)
    lib = _kernels()
    dh, dw, bands, scratch = _strip_outputs(do)
    with torch.cuda.device(do.device):
        err = lib.stc_gate_dots(do.data_ptr(), a_h.data_ptr(), a_w.data_ptr(),
                                dh.data_ptr(), dw.data_ptr(),
                                scratch.data_ptr(), _DTYPES[do.dtype], bands,
                                n, h, w, c, stream_ptr(do))
    check_launch(err, 'gate_dots')
    gate_dots.launches += 1
    return dh, dw


def gate_dots(do, a_h, a_w):
    """The backward strip sums of ``gate_add`` in one read of do (N,H,W,C):
    ``(sum over W of do·a_w -> (N,H,C), sum over H of do·a_h -> (N,W,C))``,
    both f32; a_h (N,H,C) and a_w (N,W,C) in do's dtype."""
    if do.device.type == 'cpu':
        return gate_dots_reference(do, a_h, a_w)
    if do.device.type != 'cuda':
        raise ValueError(f'gate_dots: no kernel for device {do.device}')
    return _gate_dots_kernel(do, a_h, a_w)


gate_dots.launches = 0
