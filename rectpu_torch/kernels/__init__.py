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
    counts to 0 before the main path and reads them after)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0
