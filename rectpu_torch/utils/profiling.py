"""Profiling: the port of ``rectpu/utils/profiling.py``.

``trace(logdir)`` is a ``torch.profiler`` capture of the CPU and, on the
card, of CUDA activity, written into ``logdir`` as a Chrome trace
(``*.pt.trace.json``; TensorBoard's profile plugin and Perfetto read it). A
capture of the card that holds no device event (CUPTI could not trace it)
raises instead of writing a trace without the card. ``annotate(name)`` names
a region (``torch.profiler.record_function``, and on the card an NVTX
range). ``StepTimer`` is rectpu's host-clock step and example rate over a
window.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


class Trace:
    """One profiler capture into ``logdir``, as a context manager: the block
    is traced, and on leaving it ``path`` names the trace file. ``cuda``
    (default: whether a card is available) adds the CUDA activity. A block
    that raises leaves no trace."""

    def __init__(self, logdir: str | Path, cuda: bool | None = None):
        self.logdir = Path(logdir)
        self.path: Path | None = None
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def __enter__(self) -> Trace:
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._prof.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.cuda and exc_type is None:
            torch.cuda.synchronize()
        self._prof.stop()
        if exc_type is not None:
            return
        if self.cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                                 for e in self._prof.events()):
            raise RuntimeError("the profiler traced no CUDA activity (is CUPTI available?); "
                               "no trace written")
        stamp = f"{os.getpid()}.{int(time.time() * 1e3)}"
        self.path = self.logdir / f"rectpu_torch.{stamp}.pt.trace.json"
        self._prof.export_chrome_trace(str(self.path))


def trace(logdir: str | Path, cuda: bool | None = None) -> Trace:
    """Capture a trace of a block into ``logdir``: ``with trace(dir) as t:``
    (rectpu's entry point)."""
    return Trace(logdir, cuda)


@contextlib.contextmanager
def annotate(name: str):
    """A named region for traces, ``with annotate("train_step"):`` (rectpu's
    ``jax.profiler.TraceAnnotation``): a ``torch.profiler.record_function``
    range and, where a card is present, an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Steady-state step latency and examples/sec over a window, on the host
    clock (rectpu's ``StepTimer``): ``update(steps, examples)`` after each
    chunk, ``rates()`` for the window so far, ``reset()`` to start another.
    A device timing needs its work finished first (``timing.fetch_sync``)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.reset()

    def reset(self) -> None:
        self._t0 = time.time()
        self._steps = 0
        self._examples = 0

    def update(self, steps: int, examples: int) -> None:
        self._steps += steps
        self._examples += examples

    @property
    def elapsed(self) -> float:
        return time.time() - self._t0

    def rates(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {"steps_per_sec": self._steps / dt, "examples_per_sec": self._examples / dt,
                "ms_per_step": 1e3 * dt / max(self._steps, 1)}
