"""Build the native host library: ``python -m rectpu_torch.io.native.build``.

The port's copy of ``rectpu/io/native/build.py``: ``farmhash.cc``,
``csv_loader.cc`` and ``json_columns.cc`` compiled by ``g++`` (no other
dependency) with rectpu's flags into one shared library. It goes into
``rectpu_torch/io/native/_build/`` (listed in ``.gitignore``), named by a hash
of the sources and the flags, so a changed source is rebuilt and an
unchanged one is reused. The library is written under a temporary name and
moved into place with ``os.replace``, so processes that build at once never
load a partial file. ``load`` (``rectpu_torch.io.native``) builds it at first
use; a failed build raises with g++'s output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
SOURCES = ("farmhash.cc", "csv_loader.cc", "json_columns.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", "-Wextra")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((HERE / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librectpu_io-{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless an up-to-date one is there; returns its
    path and the seconds the build took (0.0 when it was reused)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *[str(HERE / s) for s in SOURCES], "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}) building the native host "
                           f"library:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


if __name__ == "__main__":
    path, seconds = build()
    print(f"built: {path} ({seconds:.1f} s)")
