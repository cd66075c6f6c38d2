"""Device timing: the counterpart of ``rectpu/utils/timing.py``. rectpu
times chained steps on the host clock (``chained_slope_s``); the port, which
so far times single kernel calls only, has its CUDA-event timer here.

``event_ms`` times one call with CUDA events around each of many launches
and takes the median of the pairs. A sleep kernel queued first keeps the card
busy while the host enqueues every launch, so no event pair spans host
overhead: a wrapper's Python and ctypes cost is tens of microseconds, more
than many kernels take, and a forward plus backward through autograd on a
loaded host can cost a millisecond, so the sleep is sized to the host's time.
With ``flush``, a READ of a buffer larger than the card's L2 precedes each
launch, so the call finds its inputs in device memory (a flushing WRITE would
leave dirty lines whose write-back lands inside the timed call).
"""

from __future__ import annotations

import statistics
import time

import torch

CLOCK_HZ = 1.98e9  # the H100's highest SM clock: a sleep lasts at least cycles / CLOCK_HZ
SLEEP_MIN_S = 0.05


def event_ms(fn, flush: torch.Tensor | None = None, iters: int = 50) -> float:
    """Median CUDA-event time in milliseconds of one call of ``fn`` on the
    current card, after 3 warm-up calls (see the module docstring). The
    sleep lasts twice the host time of the last warm-up call for each timed
    call, and at least ``SLEEP_MIN_S``."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int(max(SLEEP_MIN_S, 2 * iters * host_s) * CLOCK_HZ))
    for start, end in pairs:
        if flush is not None:
            flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
