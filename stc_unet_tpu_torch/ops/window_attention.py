"""Relative window attention (K3f) and its backward (K3b): CUDA kernels for
Hopper.

Counterpart of ``stc_unet_tpu/ops/window_attention.py``. The kernels are in
``csrc/window_attention.cu`` and replace the Pallas kernels there:

- K3f ``stc_window_attention_fwd`` ← ``_call_fwd``/``_fwd_kernel``: per
  window and head, ``softmax(q_h k_hᵀ·scale + bias_h) v_h``, with attention
  dropout drawn inside the kernel;
- K3b ``stc_window_attention_bwd`` ← ``_call_bwd``/``_bwd_kernel``: dq, dk,
  dv and dbias (summed over the windows), recomputing the forward.

Both are bound by their exponentials on the card (W·H·N² of them), not by
bytes; the source says what the design does about it.

The layouts are the JAX function's: q, k and v are (W, N, C) with the heads
packed head-major (C = heads·d); they may be the thirds of one packed qkv
row (row stride 3C, last axis contiguous). ``bias_e`` is (N, heads·N) f32:
``bias.permute(1, 0, 2).reshape(N, heads·N)`` of an (H, N, N) bias.

Dropout draws, for element (w, h, n, m) of the attention weights, word 0 of
Philox4x32-10 at the counter ``((w·H + h)·N + n)·N + m``, keyed by the
64-bit ``seed`` (one int64 on the tensors' device, read there by the
kernel, so nothing waits on the host). The kernel and the plain version
(:func:`philox_bits` in torch integer ops) draw the same bits, so they drop
the same elements; the backward draws them again instead of storing the
mask. The TPU's generator gives other bits.

``window_attention`` is an autograd Function whose forward saves only
``(q, k, v, bias_e, seed)``, as the JAX VJP does. On CUDA tensors it
launches K3f and, in its backward, K3b, adding one to
``window_attention.launches`` or ``window_attention_backward.launches``
at each launch; it raises on anything the kernels do not take. On CPU
tensors it computes the plain versions (``window_attention_reference`` and
``window_attention_backward_reference``) and counts nothing.
"""
from __future__ import annotations

import torch

from ._build import (FLOAT, INT, PTR, UINT, check_launch, device_type,
                     load_kernels, stream_ptr)

__all__ = ['window_attention', 'window_attention_backward',
           'window_attention_reference', 'window_attention_backward_reference',
           'philox4x32', 'philox_bits']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (2, 4, 8, 16)      # the kernels' instantiations of d
_MAX_N = 64                     # rows of a window: a thread per row
_BWD_CHUNKS = 64                # K3b's windows go in at most this many chunks
_SIGNATURES = {
    'stc_window_attention_fwd': [PTR] * 6 + [INT] * 6 +
                                [FLOAT, UINT, FLOAT, INT, PTR],
    'stc_window_attention_bwd': [PTR] * 11 + [INT] * 8 +
                                [FLOAT, FLOAT, UINT, FLOAT, INT, PTR],
}
_lib = None

# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC 2011): multipliers and Weyl key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_M32 = 0xFFFFFFFF


def _kernels():
    global _lib
    if _lib is None:
        _lib = load_kernels('window_attention', _SIGNATURES)
    return _lib


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _mulhilo(a, b: int):
    """(hi, lo) 32-bit words of a·b, for int64 tensors a in [0, 2³²) and a
    32-bit constant b, in 16-bit pieces so no int64 product overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter words (c0, c1, c2, c3) under the key
    words (k0, k1): four words. Every word is a uint32 value held in an
    int64 tensor (or a 0-dim one, which broadcasts)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def philox_bits(counter, seed):
    """The kernels' dropout draws: word 0 of Philox4x32-10 at the counter
    ``(counter mod 2³², counter >> 32, 0, 0)`` under the key ``(seed mod
    2³², seed >> 32)``, as uint32 values held in int64. ``counter`` is an
    int64 tensor of non-negative values, ``seed`` an int64 tensor of one
    element on the same device."""
    zero = torch.zeros_like(counter)
    key = seed.reshape(())
    return philox4x32(counter & _M32, (counter >> 32) & _M32, zero, zero,
                      key & _M32, (key >> 32) & _M32)[0]


def _dropout_consts(rate: float, dtype):
    """The keep threshold on 32-bit draws, and 1/keep rounded to dtype (JAX
    ``_drop_mult``)."""
    keep = 1.0 - rate
    thresh = min(int(keep * 2 ** 32), 2 ** 32 - 1)
    return thresh, torch.tensor(1.0 / keep, dtype=dtype).item()


def _drop_mult(seed, shape, rate: float, dtype, device):
    """The inverted-dropout multiplier (W, H, N, N) in dtype: 1/keep where
    the element's Philox draw is below the threshold, else 0."""
    thresh, mult = _dropout_consts(rate, dtype)
    counter = torch.arange(shape.numel(), device=device).reshape(shape)
    keep = philox_bits(counter, seed.to(device)) < thresh
    return keep.to(dtype) * torch.tensor(mult, dtype=dtype, device=device)


def _split(x, heads):
    """(W, N, C) → (W, H, N, d)."""
    w, n, c = x.shape
    return x.reshape(w, n, heads, c // heads).transpose(1, 2)


def _merge(x):
    """(W, H, N, d) → (W, N, C)."""
    w, h, n, d = x.shape
    return x.transpose(1, 2).reshape(w, n, h * d)


def _attention(q, k, bias_e, heads: int, scale: float):
    """The forward recompute (JAX ``_attn_core``): the f32 attention weights
    (W, H, N, N) and q·scale rounded to q's dtype. Sums are taken in f32,
    or in f64 for f64 inputs."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    n = q.shape[1]
    qs = q * torch.tensor(scale, dtype=dt)
    s = torch.matmul(_split(qs, heads).to(acc),
                     _split(k, heads).to(acc).transpose(-1, -2))
    s = s + bias_e.reshape(n, heads, n).transpose(0, 1).to(acc)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e * (1.0 / e.sum(-1, keepdim=True)), qs


def _check_args(q, k, v, bias_e, heads, rate):
    w, n, c = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'q, k, v must share one (W, N, C) shape, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    if c % heads:
        raise ValueError(f'C={c} is not a multiple of heads={heads}')
    if tuple(bias_e.shape) != (n, heads * n):
        raise ValueError(f'bias_e has shape {tuple(bias_e.shape)}, expected '
                         f'{(n, heads * n)}')
    if not 0.0 <= rate < 1.0:
        raise ValueError(f'dropout rate {rate} not in [0, 1)')


def window_attention_reference(q, k, v, bias_e, seed, heads: int,
                               scale: float, rate: float = 0.0):
    """Plain PyTorch K3f, in the kernel's roundings: the attention weights
    are rounded to q's dtype, dropped with the kernel's Philox draws at
    ``rate``, and applied to v with f32 sums."""
    _check_args(q, k, v, bias_e, heads, rate)
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    attn, _ = _attention(q, k, bias_e, heads, scale)
    a = attn.to(dt)
    if rate > 0:
        a = a * _drop_mult(seed, a.shape, rate, dt, q.device)
    return _merge(torch.matmul(a.to(acc), _split(v, heads).to(acc))).to(dt)


def window_attention_backward_reference(q, k, v, bias_e, seed, do,
                                        heads: int, scale: float,
                                        rate: float = 0.0):
    """Plain PyTorch K3b (JAX ``_bwd_kernel``): ``(dq, dk, dv, dbias)``,
    dq, dk, dv in q's dtype and dbias (N, heads·N) in bias_e's, summed over
    the windows."""
    _check_args(q, k, v, bias_e, heads, rate)
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    w, n, c = q.shape
    attn, qs = _attention(q, k, bias_e, heads, scale)
    used = attn.to(dt)
    mult = None
    if rate > 0:
        mult = _drop_mult(seed, attn.shape, rate, dt, q.device)
        used = used * mult
    dos = _split(do, heads).to(acc)
    dv = torch.matmul(used.to(acc).transpose(-1, -2), dos).to(dt)
    dattn = torch.matmul(dos, _split(v, heads).to(acc).transpose(-1, -2))
    if mult is not None:
        dattn = dattn * mult.to(acc)
    t = dattn * attn
    ds = t - attn * t.sum(-1, keepdim=True)
    dbias = ds.sum(0).transpose(0, 1).reshape(n, heads * n)
    ds_t = ds.to(dt).to(acc)
    dq = (torch.matmul(ds_t, _split(k, heads).to(acc)) * scale).to(dt)
    dk = torch.matmul(ds_t.transpose(-1, -2),
                      _split(qs, heads).to(acc)).to(dt)
    return _merge(dq), _merge(dk), _merge(dv), dbias.to(bias_e.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _rows(name, t, shape, device, dtype):
    """The row stride of t, a (W, N, C) tensor whose rows may be longer
    than C (the thirds of a qkv row) but whose last axis is contiguous."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    w, n, c = shape
    ld = t.stride(1)
    if t.stride(2) != 1 or ld < c or (w > 1 and t.stride(0) != n * ld):
        raise ValueError(f'{name} must be (W, N, C) rows with a contiguous '
                         f'last axis, got strides {t.stride()}')
    return ld


def _kernel_args(q, k, v, bias_e, seed, heads, scale, rate):
    """Check the inputs; the launch's shape and scalar arguments."""
    _check_args(q, k, v, bias_e, heads, rate)
    if q.dtype not in _DTYPES:
        raise TypeError(f'q must be float32 or bfloat16, got {q.dtype}')
    w, n, c = q.shape
    d = c // heads
    if d not in _HEAD_DIMS or not 1 <= n <= _MAX_N:
        raise ValueError(f'no kernel for W={w}, N={n}, head dim {d} (N <= '
                         f'{_MAX_N}, d in {_HEAD_DIMS})')
    lds = {_rows(name, t, q.shape, q.device, q.dtype)
           for name, t in (('q', q), ('k', k), ('v', v))}
    if len(lds) != 1:
        raise ValueError(f'q, k, v must share one row stride, got {lds}')
    if bias_e.dtype != torch.float32 or bias_e.device != q.device or \
            not bias_e.is_contiguous():
        raise ValueError('bias_e must be contiguous float32 on the device '
                         'of q')
    if seed.dtype != torch.int64 or seed.numel() != 1 or \
            seed.device != q.device:
        raise ValueError('seed must be one int64 on the device of q')
    thresh, mult = _dropout_consts(rate, q.dtype) if rate > 0 else (0, 1.0)
    scale_q = torch.tensor(scale, dtype=q.dtype).item()
    return (_DTYPES[q.dtype], w, n, heads, d, lds.pop()), \
        (scale_q, thresh, mult, int(rate > 0))


def _fwd_kernel(q, k, v, bias_e, seed, heads, scale, rate):
    shape, (scale_q, thresh, mult, drop) = _kernel_args(
        q, k, v, bias_e, seed, heads, scale, rate)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().stc_window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_e.data_ptr(),
            seed.data_ptr(), out.data_ptr(), *shape, scale_q, thresh, mult,
            drop, stream_ptr(q))
    check_launch(err, 'window_attention')
    window_attention.launches += 1
    return out


def bwd_chunks(w: int):
    """K3b's split of W windows: (chunks, windows per chunk). It depends on
    W alone, so dbias is summed in the same order on every run."""
    wpc = -(-w // min(w, _BWD_CHUNKS))
    return -(-w // wpc), wpc


def _bwd_kernel(q, k, v, bias_e, seed, do, heads, scale, rate):
    shape, (scale_q, thresh, mult, drop) = _kernel_args(
        q, k, v, bias_e, seed, heads, scale, rate)
    if do.shape != q.shape or do.dtype != q.dtype or \
            do.device != q.device or not do.is_contiguous():
        raise ValueError('do must be contiguous, of the shape, dtype and '
                         'device of q')
    w, n, c = q.shape
    chunks, wpc = bwd_chunks(w)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    part = torch.empty((chunks, n, heads * n), dtype=torch.float32,
                       device=q.device)
    dbias = torch.empty((n, heads * n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().stc_window_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_e.data_ptr(),
            seed.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), part.data_ptr(), dbias.data_ptr(), *shape,
            chunks, wpc, scale_q, float(scale), thresh, mult, drop,
            stream_ptr(q))
    check_launch(err, 'window_attention_backward')
    window_attention_backward.launches += 1
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_e, seed, heads, scale, rate):
        ctx.save_for_backward(q, k, v, bias_e, seed)
        ctx.heads, ctx.scale, ctx.rate = heads, scale, rate
        if q.device.type == 'cpu':
            return window_attention_reference(q, k, v, bias_e, seed, heads,
                                              scale, rate)
        return _fwd_kernel(q, k, v, bias_e, seed, heads, scale, rate)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_e, seed = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_backward(
            q, k, v, bias_e, seed, do.contiguous(), ctx.heads, ctx.scale,
            ctx.rate)
        return dq, dk, dv, dbias.to(bias_e.dtype), None, None, None, None



def window_attention(q, k, v, bias_e, seed, heads: int, scale: float,
                     rate: float = 0.0):
    """``out[w] = concat_h dropout(softmax(q_h k_hᵀ·scale + bias_h)) v_h``.

    q, k, v: (W, N, C) packed head-major (C = heads·d), rows of a common
    stride with a contiguous last axis; bias_e: (N, heads·N) f32; seed: one
    int64 on the tensors' device (drawn only when ``rate > 0``); rate: the
    attention dropout. Differentiable in q, k, v and bias_e.
    """
    device_type(q, 'window_attention')
    return _WindowAttention.apply(q, k, v, bias_e, seed, heads, scale, rate)


window_attention.launches = 0


def window_attention_backward(q, k, v, bias_e, seed, do, heads: int,
                              scale: float, rate: float = 0.0):
    """``(dq, dk, dv, dbias)`` of :func:`window_attention` for the output
    gradient do (W, N, C), recomputing the forward; dbias (N, heads·N) f32
    is summed over the windows."""
    if device_type(q, 'window_attention_backward') == 'cpu':
        return window_attention_backward_reference(q, k, v, bias_e, seed, do,
                                                   heads, scale, rate)
    return _bwd_kernel(q, k, v, bias_e, seed, do, heads, scale, rate)


window_attention_backward.launches = 0
