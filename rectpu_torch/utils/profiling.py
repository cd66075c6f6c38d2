"""Profiling: the port of ``rectpu/utils/profiling.py``'s ``trace``.

``trace(logdir)`` is a ``torch.profiler`` capture of the CPU and, on the
card, of CUDA activity, written into ``logdir`` as a Chrome trace
(``*.pt.trace.json``; TensorBoard's profile plugin and Perfetto read it). A
capture of the card that holds no device event (CUPTI could not trace it)
raises instead of writing a trace without the card. Named regions come from
``torch.profiler.record_function``.
"""

from __future__ import annotations

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
