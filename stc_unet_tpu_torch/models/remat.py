"""Rematerialisation (≙ the JAX package's ``jax.checkpoint`` and
``nn.remat``): ``checkpoint(fn, *args, policy=None)`` runs ``fn(*args)``
under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so the
forward keeps only what the backward cannot recompute, and the backward
runs ``fn`` again for the rest.

The recomputed forward repeats three kinds of side effect, and each must
happen once a step:

- **The BN running stats.** ``BatchNorm`` updates ``running_mean``,
  ``running_var`` and ``num_batches_tracked`` only while
  :func:`recomputing` is false, and the recompute sets it. They come from
  the first forward, as JAX takes its ``batch_stats`` from the forward it
  differentiates.
- **The random draws.** The dropout and drop-path masks and K3's seed
  come from a ``torch.Generator`` that the caller hands down, which
  ``preserve_rng_state`` does not save (it saves only the default CPU and
  CUDA generators). So the state of every generator among ``args`` is
  taken before the forward, put back for the recompute, and the state the
  recompute found (where the forward, and every later draw, left it) is
  put back after it. The next step then draws what it draws without
  remat.
- **The global BN all-reduce under a data mesh.** It runs again in the
  recompute, inside the backward. Every rank runs the same backward, so
  every rank recomputes the same regions in the same order.

``policy='dots'`` is JAX's ``dots_with_no_batch_dims_saveable``: the
results of the plain matrix products (``mm``, ``addmm``: the Linear
layers) are saved from the forward and every other op is recomputed,
the batched products (``bmm``), the convolutions and the port's kernels
among them. A kernel launched through ctypes is invisible to the
dispatch mode that keeps the saved results: only its output buffer's
``empty`` is seen, and that is recomputed too, so the recompute launches
the kernel again and writes a fresh buffer.

Without gradients (eval, ``torch.no_grad``) ``fn`` runs plainly.
"""
from __future__ import annotations

import functools
import threading
from typing import Optional

import torch
from torch.utils import checkpoint as _checkpoint

__all__ = ['checkpoint', 'recomputing']

_state = threading.local()

_aten = torch.ops.aten
_SAVED_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})


def recomputing() -> bool:
    """Whether this thread is running a recompute of :func:`checkpoint`
    (the backward's recompute runs on the thread of the autograd node
    that needs it, and sets this there)."""
    return getattr(_state, 'depth', 0) > 0


def _dots_policy(ctx, op, *args, **kwargs):
    return (_checkpoint.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint(fn, *args, policy: Optional[str] = None):
    """``fn(*args)``, rematerialised in the backward (see the module
    docstring); ``policy`` is None (save nothing inside ``fn``) or
    ``'dots'``."""
    if policy not in (None, 'dots'):
        raise ValueError(f"policy must be None or 'dots', got {policy!r}")
    if not torch.is_grad_enabled():
        return fn(*args)
    generators = [a for a in args if isinstance(a, torch.Generator)]
    before = [g.get_state() for g in generators]
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        found = [g.get_state() for g in generators]
        for g, s in zip(generators, before):
            g.set_state(s)
        _state.depth = getattr(_state, 'depth', 0) + 1
        try:
            return fn(*a)
        finally:
            _state.depth -= 1
            for g, s in zip(generators, found):
                g.set_state(s)

    kwargs = {}
    if policy == 'dots':
        kwargs['context_fn'] = functools.partial(
            _checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    return _checkpoint.checkpoint(run, *args, use_reentrant=False, **kwargs)
