"""Model export + serving-side predict path: the port of ``rectpu/serve/export.py``.

An export is the directory rectpu writes (the reference's LatestExporter
layout, reference trainers/conf_utils.py:20-24)::

    <job_dir>/export/exporter/<timestamp>/
        arrays.npz    # model params, one key path per leaf (train.checkpoint)
        model.json    # model family + TowerConfig + feature schema

``load_model`` reads such a directory as it is, whichever package wrote it,
carries the weights across (``rectpu_torch.convert``) and returns a
``ServingModel`` whose ``predict`` takes the reference serving schema —
required features user_id, item_id, age, gender, occupation, zipcode,
release_year, with the 19 genre flags optional and defaulting to 0 — and
returns the binary head's outputs (logits / logistic / probabilities /
class_id). ``export_model`` writes the same layout from a rectpu-layout
parameter tree, without rectpu's serialized StableHLO graph
(``serialized_apply: false``).

Not ported yet (ROADMAP.md queue A): ``use_serialized=True`` (rectpu's
``apply.jaxexport`` is a StableHLO graph with no PyTorch counterpart) and
int8-quantized exports (``table_quant: "int8"``).
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from rectpu_torch.convert import deep_fm_state
from rectpu_torch.device import resolve_device
from rectpu_torch.features.schema import GENRE, FeatureSet, is_string_column, ml_100k_feature_set
from rectpu_torch.models import MODEL_REGISTRY, TowerConfig
from rectpu_torch.train.checkpoint import (
    _flatten,
    _load_flat_npz,
    _rebuild,
    _treedef_template,
)
from rectpu_torch.train.metrics import binary_predictions
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SERVING_REQUIRED = ["user_id", "item_id", "age", "gender", "occupation", "zipcode", "release_year"]


def model_toggle_kwargs(model) -> dict:
    """The ctor kwargs a model family needs to rebuild an equivalent
    instance (its EXPORT_KWARGS: DeepFM's use_linear/use_mf/use_dnn/fm_order),
    as JSON values; tuples round-trip as lists."""
    return {
        k: (list(v) if isinstance(v := getattr(model, k), tuple) else v)
        for k in model.EXPORT_KWARGS
    }


def export_model(
    params,
    model,
    job_dir: str | Path,
    step: int,
    exports_to_keep: int = 5,
) -> Path:
    """Write ``params`` (a rectpu-layout tree of tensors or arrays) under
    <job_dir>/export/exporter/<ts>/ and prune old exports."""
    if not isinstance(model.cfg.activation, str):
        raise ValueError(
            "export requires a string activation (got a callable); register "
            "it by name in models.base.get_activation"
        )
    base = Path(job_dir) / "export" / "exporter"
    base.mkdir(parents=True, exist_ok=True)
    ts = str(int(time.time() * 1000))
    tmp = base / f".tmp-{ts}"
    final = base / ts
    tmp.mkdir()
    try:
        np.savez(tmp / "arrays.npz", **_flatten(params))
        cfg = model.cfg
        meta = {
            "model": model.name,
            "step": step,
            "template": _treedef_template(params),
            "tower_config": {
                "embedding_size": cfg.embedding_size,
                "hidden_units": list(cfg.hidden_units),
                "activation": cfg.activation,
                "dropout": cfg.dropout,
                "embedding_impl": cfg.embedding_impl,
                "fm_impl": cfg.fm_impl,
                "compute_dtype": cfg.compute_dtype,
                "table_padding": cfg.table_padding,
                "fuse_linear_lookup": cfg.fuse_linear_lookup,
                "packed_linear": cfg.packed_linear,
            },
            "numeric_features": [f.name for f in cfg.feature_set.numeric],
            "model_kwargs": model_toggle_kwargs(model),
            "serialized_apply": False,
        }
        (tmp / "model.json").write_text(json.dumps(meta))
        tmp.rename(final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    exports = sorted([p for p in base.iterdir() if p.is_dir() and not p.name.startswith(".")])
    for old in exports[:-exports_to_keep] if exports_to_keep > 0 else []:
        shutil.rmtree(old, ignore_errors=True)
    logger.info("model exported: %s", final)
    return final


def latest_export(job_dir: str | Path) -> Path | None:
    base = Path(job_dir) / "export" / "exporter"
    if not base.exists():
        return None
    exports = sorted(
        p for p in base.iterdir()
        # dot-prefixed dirs are in-flight tmp/backup artifacts: never serve them
        if p.is_dir() and not p.name.startswith(".") and (p / "model.json").exists()
    )
    return exports[-1] if exports else None


class ServingModel:
    """A restored model with a predict function over raw features.

    Runs on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). PyTorch runs eagerly, so unlike rectpu's jitted apply
    there is no compile per batch size and requests are not padded to
    power-of-two buckets; ``max_batch`` is what the micro-batcher coalesces up
    to.
    """

    def __init__(self, model, feature_set: FeatureSet, max_batch: int = 4096,
                 row_perm=None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.feature_set = feature_set
        self.max_batch = max_batch
        self.row_perm = None if row_perm is None else np.asarray(row_perm, np.int32)

    def warmup(self, sizes=(1,)) -> None:
        """Run the forward once per size: loads (and at first use builds) the
        kernels and initialises the matmul library before the first request."""
        for n in sizes:
            batch = {
                "cat_ids": np.zeros((n, self.feature_set.num_fields), np.int32),
                "num_vals": np.zeros((n, self.feature_set.num_numeric), np.float32),
            }
            self.apply_encoded(batch, n)

    def encode_request(self, features: dict) -> dict:
        """Validate + encode raw serving features to dense model arrays.

        Required keys: user_id, item_id, age, gender, occupation, zipcode,
        release_year. The 19 genre flags are optional and default to 0
        (reference trainers/ml_100k.py:64-88). Returns ``{"cat_ids": [n, F]
        int32, "num_vals": [n, num_numeric] float32}`` — CPU work, safe to run
        concurrently from request threads (see serve.batching).
        """
        required = SERVING_REQUIRED + [
            f.name for f in self.feature_set.numeric
            # genre-named numerics stay optional: the GENRE loop below
            # defaults them to 0 exactly like the categorical flags
            if f.name not in SERVING_REQUIRED and f.name not in GENRE
        ]
        missing = [k for k in required if k not in features]
        if missing:
            raise ValueError(f"missing required serving features: {missing}")

        def to_column(value, name):
            # string columns go straight to a NUL-padded bytes array; the
            # hash hashes an S-dtype element's raw bytes
            if is_string_column(name):
                try:
                    return np.asarray(value, dtype=np.bytes_).reshape(-1)
                except (UnicodeEncodeError, ValueError):
                    pass  # non-ASCII: fall through to the object array
            return np.asarray(value).reshape(-1)

        n = len(np.asarray(features["user_id"]).reshape(-1))
        columns = {}
        for key in SERVING_REQUIRED:
            columns[key] = to_column(features[key], key)
        for g in GENRE:
            columns[g] = (
                np.asarray(features[g]).reshape(-1)
                if g in features
                else np.zeros(n, dtype=np.int64)
            )
        for f in self.feature_set.numeric:
            if f.name not in columns:
                columns[f.name] = np.asarray(features[f.name]).reshape(-1)
        batch = self.feature_set.encode(columns)
        batch = {k: np.asarray(v) for k, v in batch.items()}
        if self.row_perm is not None:
            # match training's frequency-aware row relabeling
            batch["cat_ids"] = self.row_perm[batch["cat_ids"]]
        if "num_vals" not in batch:
            batch["num_vals"] = np.zeros((n, 0), np.float32)
        return batch

    @torch.inference_mode()
    def _apply(self, batch: dict) -> dict:
        cat_ids = torch.from_numpy(np.ascontiguousarray(batch["cat_ids"], dtype=np.int32))
        num_vals = torch.from_numpy(np.ascontiguousarray(batch["num_vals"], dtype=np.float32))
        logits = self.model(cat_ids.to(self.device), num_vals.to(self.device))
        return binary_predictions(logits)

    def apply_encoded_async(self, batch: dict, n: int):
        """Launch the forward on an encoded batch of n rows and return the
        device tensors without waiting (CUDA launches are asynchronous). Pair
        with ``finalize``: serve.batching launches batch k+1 before batch k's
        device->host copy completes."""
        return self._apply(batch), n

    def finalize(self, out, n: int) -> dict:
        """Wait for ``apply_encoded_async``'s result and copy it to host arrays."""
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def apply_encoded(self, batch: dict, n: int) -> dict:
        return self.finalize(self._apply(batch), n)

    def predict(self, features: dict) -> dict:
        """Predict from the reference serving schema (raw feature arrays)."""
        batch = self.encode_request(features)
        return self.apply_encoded(batch, batch["cat_ids"].shape[0])


def load_model(export_dir: str | Path, use_serialized: bool = False,
               device=None) -> ServingModel:
    """Rebuild a ServingModel from an export directory (rectpu's or the
    port's), on ``device`` (default ``cuda``)."""
    if use_serialized:
        raise NotImplementedError(
            "use_serialized: the export's apply.jaxexport is a StableHLO graph with "
            "no PyTorch counterpart yet (ROADMAP.md queue A, serving)")
    device = resolve_device(device)
    export_dir = Path(export_dir)
    meta = json.loads((export_dir / "model.json").read_text())
    if meta.get("table_quant") == "int8":
        raise NotImplementedError(
            "int8-quantized exports are not served by rectpu_torch yet "
            "(ROADMAP.md queue A, serving)")
    params = _rebuild(meta["template"], _load_flat_npz(export_dir / "arrays.npz"))
    tc = meta["tower_config"]
    feature_set = ml_100k_feature_set(numeric=tuple(meta.get("numeric_features", ())))
    cfg = TowerConfig(
        feature_set=feature_set,
        embedding_size=tc["embedding_size"],
        hidden_units=tuple(tc["hidden_units"]),
        activation=tc["activation"],
        dropout=tc["dropout"],
        embedding_impl=tc.get("embedding_impl", "auto"),
        fm_impl=tc.get("fm_impl", "auto"),
        compute_dtype=tc.get("compute_dtype"),
        table_padding=tc.get("table_padding", 128),
        fuse_linear_lookup=tc.get("fuse_linear_lookup", True),
        packed_linear=tc.get("packed_linear", False),
    )
    model = MODEL_REGISTRY[meta["model"]](cfg, **meta.get("model_kwargs", {}))
    model.load_state(deep_fm_state(model, params, device))
    row_perm = None
    if meta.get("row_placement"):
        row_perm = np.load(export_dir / "row_perm.npy")
    return ServingModel(model, feature_set, row_perm=row_perm, device=device)
