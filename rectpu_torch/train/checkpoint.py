"""The numpy side of rectpu's checkpoint/export array format.

An export's ``arrays.npz`` holds every leaf of the parameter tree under its
``/``-joined key path (``mlp/0/kernel``, ``linear/b``, ``table``), and
``model.json`` holds the tree's skeleton (``_treedef_template``). These are
the functions of ``rectpu/train/checkpoint.py`` that read and write that
format, without JAX: the same key paths (dict keys in sorted order, list
indices), the same skeleton, and the same ``__bf16__`` tag — npz cannot store
bfloat16, so a bf16 leaf is written as its uint16 bit pattern under
``<key>__bf16__`` and read back here as a ``torch.bfloat16`` view.
"""

from __future__ import annotations

import numpy as np
import torch

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
