"""Post-training int8 quantization of embedding tables for serving: the port
of ``rectpu/serve/quant.py``.

Symmetric per-row int8 (``quantize_rows``, bit for bit rectpu's numpy): the
table of an export stored as ``{"q": int8 [V, W], "s": float32 [V]}``, about
4x smaller, the elementwise error at most max|row| / 254. ``load_model``
serves such an export (``model.json``'s ``"table_quant": "int8"``): the
table leaf selects the gather kernel's int8 mode in
``models.base.lookup_fields`` (``ops.embedding.dequant_gather``), so no model
gains an argument, and the quantized model never takes the flat layout, as
rectpu's models skip it under a ``lookup_fn``.

Two entry points, as in rectpu:

- ``quantize_export(export_dir)`` rewrites an export with the table
  quantized (in place by an atomic swap, or into ``out_dir``). CLI:
  ``python -m rectpu_torch.serve.quant <export_dir> [--out DIR]``.
- ``quantize_serving(served)`` quantizes a loaded ``ServingModel`` in memory
  (``rectpu_torch.serve.server --table-quant int8``).

Only the embedding table is quantized. A model whose linear tower rides the
table's gather (``fuse_linear_lookup``) is first re-expressed in its packed
[V, K+1] form (``models.base.pack_fused_table``), so the quantized leaf is
the one the gather reads. The linear model has no table and passes through
unchanged. Both rewrite arrays on the host and launch nothing.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np

from rectpu_torch.convert import load_params, params_tree
from rectpu_torch.models.base import is_quantized, pack_fused_table
from rectpu_torch.train.checkpoint import _flatten, _treedef_template, to_tensor
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _float32(leaf) -> np.ndarray:
    return to_tensor(leaf).detach().cpu().float().numpy()


def quantize_rows(arr) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: ``q = round(row / s)``, ``s = max|row| / 127``.

    Zero rows get scale 1 (q = 0 exactly). Elementwise error <= s / 2."""
    arr = _float32(arr)
    absmax = np.abs(arr).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(arr / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_rows(q, scale) -> np.ndarray:
    return np.asarray(q, np.float32) * np.asarray(scale, np.float32)[:, None]


def quantize_params(model, params: dict):
    """Quantize the table leaf of (model, params), params a rectpu-layout
    tree of tensors or arrays.

    Returns ``(model', params', quantized)``: ``model'`` is packed
    (``packed_linear``) when the linear weight was fused into the gather,
    and never takes the flat layout; ``params'`` carries the table as
    ``{"q", "s"}``. ``quantized`` is False, and (model, params) come back as
    they were, when the model has no embedding table (the linear model) or
    its table is quantized already."""
    if is_quantized(params.get("table")) or is_quantized(params.get("emb")):
        return model, params, False
    fuses = (
        "emb" in params
        and "w" in params.get("linear", {})
        and model.cfg.fuse_linear_lookup
        # DeepFM fuses only with the linear tower beside mf or dnn
        and getattr(model, "use_linear", True)
        and (getattr(model, "use_mf", True) or getattr(model, "use_dnn", True))
    )
    if "table" not in params and "emb" not in params:
        return model, params, False
    params = dict(params)
    if fuses:
        params["linear"] = dict(params["linear"])
        w = to_tensor(params["linear"].pop("w"))
        params["table"] = pack_fused_table(to_tensor(params.pop("emb")), w)
    key = "table" if "table" in params else "emb"
    q, s = quantize_rows(params[key])
    params[key] = {"q": q, "s": s}
    from rectpu_torch.serve.export import model_toggle_kwargs

    cfg = dataclasses.replace(model.cfg, flat_layout=False,
                              packed_linear=model.cfg.packed_linear or fuses)
    return model.__class__(cfg, **model_toggle_kwargs(model)), params, True


def quantize_serving(served):
    """In-memory quantization of a loaded ``ServingModel``, on its device."""
    from rectpu_torch.serve.export import ServingModel

    model, params, did = quantize_params(served.model, params_tree(served.model))
    if not did:
        return served
    load_params(model, params, served.device)
    return ServingModel(model, served.feature_set, max_batch=served.max_batch,
                        row_perm=served.row_perm, device=served.device)


def quantize_export(export_dir, out_dir=None) -> Path:
    """Rewrite an export directory with an int8-quantized table.

    In place by default (an atomic swap); ``out_dir`` writes a sibling
    export instead. The serialized programs are dropped (they were traced
    over float params): ``load_model(..., use_serialized=True)`` on a
    quantized export raises."""
    from rectpu_torch.serve.export import load_model

    export_dir = Path(export_dir)
    meta = json.loads((export_dir / "model.json").read_text())
    if meta.get("table_quant"):
        raise ValueError(f"{export_dir}: already quantized ({meta['table_quant']})")
    served = load_model(export_dir, device="cpu")
    model, params, did = quantize_params(served.model, params_tree(served.model))
    if not did:
        raise ValueError(f"{export_dir}: model has no embedding table to quantize")

    meta["table_quant"] = "int8"
    meta["template"] = _treedef_template(params)
    meta["tower_config"]["packed_linear"] = model.cfg.packed_linear
    meta["serialized_apply"] = False
    meta.pop("serialized_apply_error", None)
    meta["serialized_apply_torch"] = False
    meta.pop("serialized_apply_torch_error", None)

    dest = Path(out_dir) if out_dir is not None else export_dir
    tmp = dest.parent / f".tmp-quant-{dest.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        np.savez(tmp / "arrays.npz", **_flatten(params))
        (tmp / "model.json").write_text(json.dumps(meta))
        if (export_dir / "row_perm.npy").exists():
            shutil.copy2(export_dir / "row_perm.npy", tmp / "row_perm.npy")
        if dest.exists():
            # swap with a way back: if the second rename fails the original
            # returns, so dest is never missing (the dot name also keeps
            # latest_export from serving the backup)
            old = dest.parent / f".old-{dest.name}"
            if old.exists():
                shutil.rmtree(old)
            dest.rename(old)
            try:
                tmp.rename(dest)
            except BaseException:
                old.rename(dest)
                raise
            shutil.rmtree(old)
        else:
            tmp.rename(dest)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dest


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("export_dir", help="export directory to quantize")
    ap.add_argument("--out", default=None,
                    help="write the quantized export here instead of in place")
    a = ap.parse_args(argv)
    dest = quantize_export(a.export_dir, a.out)
    logger.info("quantized export written: %s", dest)


if __name__ == "__main__":
    main()
