"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with a
plain C interface, and loaded with ``ctypes``. No PyTorch header is included,
so a source builds in seconds (``torch.utils.cpp_extension`` needs minutes for
the same kernel). The libraries go into ``rectpu_torch/kernels/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is reused.

The build happens at first use (``load``), or ahead of time for every source
at once, one ``nvcc`` per source, all started together::

    python -m rectpu_torch.kernels.build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("embedding_lookup", "fm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's stderr: ptxas register and shared-memory report


def nvcc() -> str:
    """The nvcc to build with: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
                       "kernels of rectpu_torch build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> list[BuildResult]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all running at once. Raises with nvcc's output if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, procs = [], []
    for name in names:
        out = library_path(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        results.append(BuildResult(name, out, seconds, stderr))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return results


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to ``(argtypes, restype)``; pointers
    and the stream are ``ctypes.c_void_p`` (a bare int would be cut to 32
    bits)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


if __name__ == "__main__":
    t0 = time.perf_counter()
    for r in build():
        print(f"{r.name}: {r.path} ({r.seconds:.1f} s)")
        if r.log:
            print(r.log.rstrip())
    print(f"built in {time.perf_counter() - t0:.1f} s")
