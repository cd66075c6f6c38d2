"""Hand-written CUDA kernels for Hopper and their launch counts.

``csrc/`` holds the sources, ``build.py`` compiles and loads them. The
wrappers live beside their plain PyTorch versions in ``rectpu_torch/ops/``.
"""

from __future__ import annotations

import threading


class LaunchCount:
    """How many times a wrapper launched its kernel.

    The wrapper calls ``add()`` where it launches and nowhere else, so a run
    can show that its path went through the kernel (``chip_smoke.py`` sets the
    counts to 0 before the main path and reads them after).

    A CUDA graph replays launches without running the wrapper: the trainer's
    step graph (``train/dispatch.StepGraph``) adds the launches its capture
    recorded to ``captured`` (a capture launches nothing) and, at every
    replay, to ``replayed``; ``total`` is the launches that ran."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.captured = 0
        self.replayed = 0
        self._lock = threading.Lock()
        _COUNTS.append(self)

    def add(self) -> None:
        with self._lock:
            self.value += 1

    @property
    def total(self) -> int:
        return self.value - self.captured + self.replayed

    def reset(self) -> None:
        with self._lock:
            self.value = self.captured = self.replayed = 0


_COUNTS: list = []


def launch_counts() -> list:
    """Every ``LaunchCount`` made so far (one per wrapper module imported)."""
    return list(_COUNTS)
