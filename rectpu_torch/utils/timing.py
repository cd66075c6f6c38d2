"""Device timing: the port of ``rectpu/utils/timing.py``, and the port's
CUDA-event timer.

``chained_slope_s`` is rectpu's step timer: a dependency-chained loop ``x =
step_fn(x)`` run at two iteration counts, each ended by ``fetch_sync`` (a real
device-to-host read of one element, so the host clock stops only after the
work has run), and the slope between the two, in which the fixed costs of
the read and the first dispatch cancel. Host contention can make the slope 0
or negative; the fallback is then the longer run's time per iteration,
fixed costs included, so the result is always positive.

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


def _first_leaf(x):
    """The first tensor of a (nested) dict / list / tuple, in sorted key
    order for a dict (JAX's ``tree_leaves`` order), or ``x`` itself."""
    while isinstance(x, (dict, list, tuple)):
        x = x[sorted(x)[0]] if isinstance(x, dict) else x[0]
    return x


def fetch_sync(x) -> None:
    """Wait until everything queued before the work that wrote ``x`` (a
    tensor, or a nested dict / list / tuple of them: its first leaf) has run,
    by copying one element of it to the host (rectpu's ``fetch_sync``)."""
    leaf = _first_leaf(x)
    (leaf if leaf.dim() == 0 else leaf.reshape(-1)[:1]).cpu()


def chained_slope_s(step_fn, x0, iters=(40, 120), repeats: int = 1) -> float:
    """Seconds per iteration of ``x = step_fn(x)``, fixed costs cancelled
    (rectpu's, the module docstring): after one warm-up call and its
    ``fetch_sync``, ``iters[0]`` then ``iters[1]`` chained iterations, each
    ended by a ``fetch_sync``, give (t2 - t1) / (n2 - n1). With ``repeats`` >
    1 the two-point measurement repeats and the least positive slope is
    returned (load on the host only adds time); if none is positive, the
    least time per iteration of the longer runs."""
    n1, n2 = iters
    if not n2 > n1 > 0:
        raise ValueError(f"iters must be two counts 0 < n1 < n2, got {iters}")
    x = step_fn(x0)
    fetch_sync(x)
    best = fallback = float("inf")
    for _ in range(max(repeats, 1)):
        t = []
        for n in (n1, n2):
            t0 = time.perf_counter()
            for _ in range(n):
                x = step_fn(x)
            fetch_sync(x)
            t.append(time.perf_counter() - t0)
        slope = (t[1] - t[0]) / (n2 - n1)
        if slope > 0:
            best = min(best, slope)
        fallback = min(fallback, t[1] / n2)
    return best if best != float("inf") else fallback


def chained_slope_ms(step_fn, x0, iters=(40, 120), repeats: int = 1) -> float:
    """``chained_slope_s`` in milliseconds."""
    return 1e3 * chained_slope_s(step_fn, x0, iters, repeats)
