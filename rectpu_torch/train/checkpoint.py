"""Checkpoints and rectpu's checkpoint/export array format: the port of
``rectpu/train/checkpoint.py``.

An export's or checkpoint's ``arrays.npz`` holds every leaf of a tree under
its ``/``-joined key path (``mlp/0/kernel``, ``opt_state/m/table``), and the
JSON beside it holds the tree's skeleton (``_treedef_template``). These
functions read and write that format without JAX: the same key paths (dict
keys in sorted order, list indices), the same skeleton, and the same
``__bf16__`` tag — npz cannot store bfloat16, so a bf16 leaf is written as its
uint16 bit pattern under ``<key>__bf16__`` and read back here as a
``torch.bfloat16`` view. ``Checkpointer`` writes ``<job_dir>/ckpt-<step>/``
(``arrays.npz`` + ``meta.json``) atomically and keeps the newest N, so either
package restores the other's checkpoints.
"""

from __future__ import annotations

import json
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SEP = "/"
_BF16_TAG = "__bf16__"


def _leaf_numpy(leaf) -> tuple[np.ndarray, bool]:
    """(array, is_bf16) for a tensor or array leaf; bf16 comes back as uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 (a JAX host array)
        return arr.view(np.uint16), True
    return arr, False


def _flatten(tree) -> dict:
    """{key path: numpy array} over the leaves of a dict/list tree, in the
    order and with the keys ``jax.tree_util`` gives (sorted dict keys)."""
    flat = {}

    def walk(node, path):
        if node is None:
            return  # an empty subtree, as in JAX
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            arr, bf16 = _leaf_numpy(node)
            key = _SEP.join(path)
            flat[key + _BF16_TAG if bf16 else key] = arr

    walk(tree, [])
    return flat


def to_tensor(leaf) -> torch.Tensor:
    """A CPU tensor from a numpy array (ml_dtypes bf16 included) or a tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr, bf16 = _leaf_numpy(leaf)
    if bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _load_flat_npz(path) -> dict:
    """{key path: CPU tensor} from an npz written by ``_flatten`` (either
    package's), undoing the bf16 uint16 tagging."""
    with np.load(path) as z:
        flat = {}
        for k in z.files:
            arr = z[k]
            if k.endswith(_BF16_TAG):
                flat[k[: -len(_BF16_TAG)]] = torch.from_numpy(
                    arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(arr)
    return flat


def _treedef_template(tree):
    """A JSON-serializable skeleton of the tree (dicts/lists/leaf markers)."""
    if isinstance(tree, dict):
        return {k: _treedef_template(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_treedef_template(v) for v in tree]
    return None  # leaf


def _rebuild(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, prefix + k + _SEP) for k, v in template.items()}
    if isinstance(template, list):
        return [_rebuild(v, flat, prefix + str(i) + _SEP) for i, v in enumerate(template)]
    return flat[prefix[:-1]]


class Checkpointer:
    """Atomic keep-N checkpointer (``rectpu/train/checkpoint.py:88-194``).

    ``save`` copies the tree to the host at once; with ``async_write`` the
    npz serialization and disk write run on one background thread, and the
    next ``save``, ``restore`` or ``wait`` joins it first (so the keep-N
    rotation never races a write)."""

    def __init__(self, job_dir: str | Path, keep: int = 5, prefix: str = "ckpt",
                 async_write: bool = False):
        self.job_dir = Path(job_dir)
        self.keep = keep
        self.prefix = prefix
        self.async_write = async_write
        self._pending = None
        self._executor = None
        self.job_dir.mkdir(parents=True, exist_ok=True)

    def wait(self) -> None:
        """Block until any in-flight write has committed (raises its error)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _ckpt_dir(self, step: int) -> Path:
        return self.job_dir / f"{self.prefix}-{step}"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.job_dir.glob(f"{self.prefix}-*"):
            if p.is_dir() and (p / "meta.json").exists():
                try:
                    steps.append(int(p.name.rsplit("-", 1)[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: dict, extra_meta: dict | None = None) -> Path:
        """Write a checkpoint of ``tree`` (a dict/list tree of tensors or arrays)."""
        self.wait()
        # host copies, taken now: training updates the tensors in place
        flat = {k: np.array(v, copy=True) for k, v in _flatten(tree).items()}
        template = _treedef_template(tree)
        if self.async_write:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=1,
                                                    thread_name_prefix="rectpu-torch-ckpt")
            self._pending = self._executor.submit(self._write, step, flat, template,
                                                  extra_meta)
            return self._ckpt_dir(step)
        return self._write(step, flat, template, extra_meta)

    def _write(self, step: int, flat: dict, template, extra_meta: dict | None) -> Path:
        final = self._ckpt_dir(step)
        tmp = self.job_dir / f".tmp-{self.prefix}-{step}-{time.time_ns()}"
        tmp.mkdir(parents=True)
        try:
            np.savez(tmp / "arrays.npz", **flat)
            meta = {"step": step, "template": template, "time": time.time()}
            meta.update(extra_meta or {})
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._rotate()
        logger.debug("checkpoint saved: %s", final)
        return final

    def restore(self, step: int | None = None) -> tuple[dict, dict] | None:
        """(tree of CPU tensors, meta) for ``step`` (default the latest), or None."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        d = self._ckpt_dir(step)
        meta = json.loads((d / "meta.json").read_text())
        return _rebuild(meta["template"], _load_flat_npz(d / "arrays.npz")), meta

    def _rotate(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._ckpt_dir(s), ignore_errors=True)
