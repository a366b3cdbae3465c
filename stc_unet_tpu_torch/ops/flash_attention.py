"""Flash attention (L): the forward (Lf) and its backward (Ldkv, Ldq), CUDA
kernels for Hopper.

Counterpart of JAX's library flash attention
(``jax.experimental.pallas.ops.tpu.flash_attention``), which the JAX STC-UNet
calls when ``UnetBackbone(flash_attention=True)``
(``stc_unet_tpu/models/backbones/unet_backbone.py:146``). The kernels are in
``csrc/flash_attention.cu`` and replace the library's three Pallas kernels
(jax 0.9.0):

- Lf ``stc_flash_attention_fwd`` ← ``_flash_attention_impl``:
  ``o = softmax((q·kᵀ)·sm_scale)·v`` with an online softmax, and the
  per-row log-sum-exp ``lse`` (the library keeps its ``l`` and ``m``);
- Ldkv ``stc_flash_attention_bwd_dkv`` ← ``_flash_attention_bwd_dkv``: dk
  and dv, a block per key tile walking the query tiles;
- Ldq ``stc_flash_attention_bwd_dq`` ← ``_flash_attention_bwd_dq``: dq, a
  block per query tile walking the key tiles.

All three are bound by their f32 products on the card. Lf computes them as
f32 FMAs on the CUDA cores; Ldkv and Ldq on the tensor cores in 3xTF32
(each operand split into two TF32 halves, three products summed in f32),
which keeps f32 accuracy and does not read torch's TF32 flags. The source
says what each design does about its bound. The backward's
``di = Σ_d o·do`` is one plain reduction here, as the library forms it
outside its kernels (``_flash_attention_bwd``).

q, k, v are (N, heads, L, d) float32 with any strides of the first three
axes and a contiguous last one (the model's are views of its (N, L, C)
projections); Lq and Lk are any length and d is 1..256: the library's
multiple-of-128 blocks are its TPU tiling, not part of the function.

``flash_attention`` is an autograd Function whose forward saves ``(q, k,
v, o, lse)``, as the library's VJP does. On CUDA tensors it launches Lf
and, in its backward, Ldkv and Ldq, adding one to
``flash_attention_forward.launches``, ``flash_attention_bwd_dkv.launches``
or ``flash_attention_bwd_dq.launches`` at each launch; it raises on
anything the kernels do not take. On CPU tensors it computes the plain
versions (``flash_attention_reference``, and
``flash_attention_backward_reference``: the plain Ldkv and Ldq,
``flash_attention_bwd_dkv_reference`` and
``flash_attention_bwd_dq_reference``) and counts nothing.
"""
from __future__ import annotations

import torch

from ._build import (FLOAT, INT, LONG, PTR, check_launch, device_type,
                     load_kernels, stream_ptr)

__all__ = ['flash_attention', 'flash_attention_forward',
           'flash_attention_backward', 'flash_attention_bwd_dkv',
           'flash_attention_bwd_dq', 'flash_attention_reference',
           'flash_attention_backward_reference',
           'flash_attention_bwd_dkv_reference',
           'flash_attention_bwd_dq_reference']

_MAX_D = 256                 # the kernels' widest head
_ROWS = [PTR, LONG, LONG, LONG]   # one (N, H, L, d) input and its strides
_SIGNATURES = {
    'stc_flash_attention_fwd': _ROWS * 3 + [PTR, PTR] + [INT] * 5 +
                               [FLOAT, PTR],
    'stc_flash_attention_bwd_dkv': _ROWS * 4 + [PTR] * 4 + [INT] * 5 +
                                   [FLOAT, PTR],
    'stc_flash_attention_bwd_dq': _ROWS * 4 + [PTR] * 3 + [INT] * 5 +
                                  [FLOAT, PTR],
}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        _lib = load_kernels('flash_attention', _SIGNATURES)
    return _lib


def _check_args(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f'q, k, v must be (N, heads, L, d), got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f'k and v must be (N, heads, Lk, d) of q\'s N, '
                         f'heads and d, got q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, sm_scale):
    """``(q·kᵀ)·sm_scale``, summed in f32 (f64 for f64 inputs)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    return torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * sm_scale


def flash_attention_reference(q, k, v, sm_scale: float):
    """Plain PyTorch Lf: ``(o, lse)`` with ``o = softmax((q·kᵀ)·sm_scale)·v``
    and ``lse`` (N, heads, Lq) the log-sum-exp of each row of the scores."""
    _check_args(q, k, v)
    s = _scores(q, k, sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, v.to(s.dtype)) / l
    return o, (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, sm_scale):
    """The attention weights ``exp(s - lse)``, recomputed from q, k and
    the forward's lse."""
    s = _scores(q, k, sm_scale)
    return torch.exp(s - lse.to(s.dtype)[..., None])


def _ds(p, v, do, di, sm_scale):
    """``p·(do·vᵀ - di)·sm_scale``, the scores' gradient."""
    dp = torch.matmul(do.to(p.dtype), v.to(p.dtype).transpose(-1, -2))
    return (dp - di.to(p.dtype)[..., None]) * p * sm_scale


def flash_attention_bwd_dkv_reference(q, k, v, lse, do, di,
                                      sm_scale: float):
    """Plain PyTorch Ldkv: ``(dk, dv)`` from the forward's lse and ``di =
    Σ_d o·do``: ``dv = pᵀ·do``, ``dk = dsᵀ·q``."""
    p = _probs(q, k, lse, sm_scale)
    ds = _ds(p, v, do, di, sm_scale)
    return (torch.matmul(ds.transpose(-1, -2), q.to(p.dtype)),
            torch.matmul(p.transpose(-1, -2), do.to(p.dtype)))


def flash_attention_bwd_dq_reference(q, k, v, lse, do, di, sm_scale: float):
    """Plain PyTorch Ldq: ``dq = ds·k``."""
    p = _probs(q, k, lse, sm_scale)
    return torch.matmul(_ds(p, v, do, di, sm_scale), k.to(p.dtype))


def _di(o, do):
    """``Σ_d o·do`` (N, heads, Lq), f32, as ``_flash_attention_bwd`` forms
    it."""
    acc = torch.promote_types(o.dtype, torch.float32)
    return (o.to(acc) * do.to(acc)).sum(-1)


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       sm_scale: float):
    """Plain PyTorch Ldkv and Ldq: ``(dq, dk, dv)`` of
    :func:`flash_attention` for the output gradient do, from the forward's
    o and lse."""
    _check_args(q, k, v)
    di = _di(o, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, lse, do, di, sm_scale)
    return (flash_attention_bwd_dq_reference(q, k, v, lse, do, di, sm_scale),
            dk, dv)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _rows(name, t, shape, device):
    """t's pointer and (N, H, L) element strides, for a launch."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name} must be float32, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if t.stride(3) != 1 and t.shape[3] != 1:
        raise ValueError(f'{name} must have a contiguous last axis, got '
                         f'strides {t.stride()}')
    return (t.data_ptr(),) + tuple(t.stride()[:3])


def _shape_args(q, k, v):
    """Check the inputs; their pointers and strides and the launch's
    shape."""
    _check_args(q, k, v)
    n, h, lq, d = q.shape
    lk = k.shape[2]
    if not 1 <= d <= _MAX_D or n * h > 65535 or min(n, h, lq, lk) < 1:
        raise ValueError(f'no kernel for q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)} (d in 1..{_MAX_D}, N·heads <= '
                         f'65535)')
    ptrs = (_rows('q', q, q.shape, q.device) + _rows('k', k, k.shape, q.device)
            + _rows('v', v, k.shape, q.device))
    return ptrs, (n, h, lq, lk, d)


def _contiguous_f32(name, t, shape, device):
    if t.dtype != torch.float32 or t.device != device or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous float32 {tuple(shape)} '
                         f'on {device}')


def _fwd_kernel(q, k, v, sm_scale):
    ptrs, shape = _shape_args(q, k, v)
    n, h, lq, _, d = shape
    o = torch.empty((n, h, lq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((n, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().stc_flash_attention_fwd(
            *ptrs, o.data_ptr(), lse.data_ptr(), *shape, float(sm_scale),
            stream_ptr(q))
    check_launch(err, 'flash_attention_forward')
    flash_attention_forward.launches += 1
    return o, lse


def _bwd_args(q, k, v, lse, do, di):
    ptrs, shape = _shape_args(q, k, v)
    ptrs += _rows('do', do, q.shape, q.device)
    for name, t in (('lse', lse), ('di', di)):
        _contiguous_f32(name, t, q.shape[:3], q.device)
    return ptrs + (lse.data_ptr(), di.data_ptr()), shape


def _dkv_kernel(q, k, v, lse, do, di, sm_scale):
    ptrs, shape = _bwd_args(q, k, v, lse, do, di)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().stc_flash_attention_bwd_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *shape, float(sm_scale),
            stream_ptr(q))
    check_launch(err, 'flash_attention_bwd_dkv')
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _dq_kernel(q, k, v, lse, do, di, sm_scale):
    ptrs, shape = _bwd_args(q, k, v, lse, do, di)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().stc_flash_attention_bwd_dq(
            *ptrs, dq.data_ptr(), *shape, float(sm_scale), stream_ptr(q))
    check_launch(err, 'flash_attention_bwd_dq')
    flash_attention_bwd_dq.launches += 1
    return dq



def flash_attention_forward(q, k, v, sm_scale: float):
    """Lf: ``(o, lse)``, o (N, heads, Lq, d) and lse (N, heads, Lq), both
    f32; see :func:`flash_attention`. Not differentiable."""
    if device_type(q, 'flash_attention_forward') == 'cpu':
        return flash_attention_reference(q, k, v, sm_scale)
    return _fwd_kernel(q, k, v, sm_scale)


flash_attention_forward.launches = 0


def flash_attention_bwd_dkv(q, k, v, lse, do, di, sm_scale: float):
    """Ldkv: ``(dk, dv)`` of :func:`flash_attention` for the output gradient
    do, from the forward's lse and ``di = Σ_d o·do`` (N, heads, Lq)."""
    if device_type(q, 'flash_attention_bwd_dkv') == 'cpu':
        return flash_attention_bwd_dkv_reference(q, k, v, lse, do, di,
                                                 sm_scale)
    return _dkv_kernel(q, k, v, lse, do, di, sm_scale)


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, lse, do, di, sm_scale: float):
    """Ldq: dq of :func:`flash_attention`, as :func:`flash_attention_bwd_dkv`
    takes its inputs."""
    if device_type(q, 'flash_attention_bwd_dq') == 'cpu':
        return flash_attention_bwd_dq_reference(q, k, v, lse, do, di,
                                                sm_scale)
    return _dq_kernel(q, k, v, lse, do, di, sm_scale)


flash_attention_bwd_dq.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, sm_scale: float):
    """``(dq, dk, dv)`` of :func:`flash_attention` for the output gradient
    do: di, then Ldkv and Ldq."""
    if device_type(q, 'flash_attention_backward') == 'cpu':
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  sm_scale)
    di = _di(o, do)
    dk, dv = _dkv_kernel(q, k, v, lse, do, di, sm_scale)
    return _dq_kernel(q, k, v, lse, do, di, sm_scale), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_attention_forward(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale: float = 1.0):
    """``softmax((q·kᵀ)·sm_scale)·v`` over (N, heads, L, d) float32 q, k, v
    (the library's ``flash_attention(q, k, v, sm_scale=...)``), without
    forming the (Lq, Lk) scores on the card. Differentiable in q, k, v."""
    device_type(q, 'flash_attention')
    return _FlashAttention.apply(q, k, v, sm_scale)
