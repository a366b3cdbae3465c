"""Timers of a call on the card, in ms.

``event_ms`` puts a CUDA event pair around each call. The card is idle
when the start event is queued, so the pair also counts the host's time to
queue the call: a wrapper's checks, allocations and launch. That is what
``chip_smoke.py`` has reported as ``ms`` since its first version.

``device_ms`` hides the host's time: a ``torch.cuda._sleep`` kernel queued
first keeps the card busy while the host queues the start event, the call
and the end event, so the pair times the call's kernels back to back. It
checks that the sleep outlasted the host (the start event still pending
once the end event is queued) and doubles the sleep until it does. A call
that waits on the card itself (a copy to the host, ``.item()`` of a CUDA
tensor) cannot be timed so, and raises.
"""
from __future__ import annotations

import statistics
import time

import torch

_SLEEP_CYCLES_PER_S = 2.0e9   # about the SM clock of an H100 SXM (1.98 GHz)
_MAX_SLEEP_S = 1.0


def event_ms(fn, warmup=2, iters=10):
    """Median time of one call from a CUDA event pair around it, host
    time included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, warmup=2, iters=10):
    """Median time of one call's kernels on the card, with the host's work
    hidden behind a sleep kernel queued before the start event."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    sleep_s = max(2e-4, 4 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    times = []
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * _SLEEP_CYCLES_PER_S))
        start.record()
        fn()
        end.record()
        hidden = not start.query()
        end.synchronize()
        if hidden:
            times.append(start.elapsed_time(end))
        elif sleep_s >= _MAX_SLEEP_S:
            raise RuntimeError('device_ms: the host was still queueing the '
                               'call after a 1 s sleep; does it wait on the '
                               'card?')
        else:
            sleep_s *= 2
    return statistics.median(times)
