"""Model export + serving-side predict path: the port of ``rectpu/serve/export.py``.

An export is the directory rectpu writes (the reference's LatestExporter
layout, reference trainers/conf_utils.py:20-24)::

    <job_dir>/export/exporter/<timestamp>/
        arrays.npz    # model params, one key path per leaf (train.checkpoint)
        model.json    # model family + TowerConfig + feature schema

``load_model`` reads such a directory as it is, whichever package wrote it,
carries the weights across (``rectpu_torch.convert``, fp32 masters kept: a
bf16 tower casts them before each gather and matmul, as rectpu does) and
returns a
``ServingModel`` whose ``predict`` takes the reference serving schema —
required features user_id, item_id, age, gender, occupation, zipcode,
release_year, with the 19 genre flags optional and defaulting to 0 — and
returns the binary head's outputs (logits / logistic / probabilities /
class_id). An int8-quantized export (``"table_quant": "int8"``,
``serve/quant.py``) is served through the gather kernel's int8 mode.

``export_model`` writes the same layout from a rectpu-layout parameter tree,
and beside it ``apply.pt2``: the port's counterpart of rectpu's
``apply.jaxexport`` (a StableHLO graph, ``rectpu/serve/export.py:67-105``,
which the port cannot run; ``"serialized_apply"`` keeps its meaning and is
false in the port's exports). ``apply.pt2`` is a ``torch.export`` program of
the forward, cat_ids [b, F] int32 and num_vals [b, N] fp32 to logits [b]
fp32, with a dynamic batch dimension and the parameters as inputs, so the
weights live only in ``arrays.npz`` (the example inputs are not saved).
As rectpu pins its graph to shape-polymorphic kernels (plain gather, XLA
FM, no flat layout), the program is traced without the flat layout, and the
kernels it runs are the registered forward ops ``rectpu_torch::gather``,
``::fm_cross``, ``::interact`` (exact products) and ``::cin``: the port's
kernels on CUDA tensors and their plain versions on CPU tensors.
``model.json`` records ``"serialized_apply_torch": true``, or false and the
error (``"serialized_apply_torch_error"``) where export failed, as rectpu
records its own. ``load_model(..., use_serialized=True)`` runs the program
without the model's Python code.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from rectpu_torch.convert import flatten_tree, load_params
from rectpu_torch.device import resolve_device
from rectpu_torch.features.schema import GENRE, FeatureSet, is_string_column, ml_100k_feature_set
from rectpu_torch.models import MODEL_REGISTRY, TowerConfig
from rectpu_torch.train.checkpoint import (
    _flatten,
    _load_flat_npz,
    _rebuild,
    _treedef_template,
    to_tensor,
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


PROGRAM = "apply.pt2"
_PROGRAMS: dict = {}  # traced program bytes by (family, config, toggles, leaves)
_PROGRAMS_LOCK = threading.Lock()


class _Apply(torch.nn.Module):
    """The exported function: (params, cat_ids, num_vals) -> logits, the
    params swapped into ``model`` by ``functional_call``. The model is held
    outside the module tree, so none of its tensors is lifted into the
    program."""

    def __init__(self, model):
        super().__init__()
        object.__setattr__(self, "_model", model)

    def forward(self, params: dict, cat_ids: torch.Tensor, num_vals: torch.Tensor):
        return torch.func.functional_call(self._model, params, (cat_ids, num_vals))


def _program_params(params) -> dict:
    """{module parameter name: CPU tensor} of a rectpu-layout tree: the
    program's first input."""
    return {k.replace("/", "."): to_tensor(v).detach().cpu().contiguous()
            for k, v in flatten_tree(params).items()}


def _serialized_apply_bytes(model, params) -> bytes:
    """The ``torch.export`` program of ``model``'s forward as bytes (see the
    module docstring), traced once per family, config, toggles and parameter
    shapes in a process (a failure is remembered too)."""
    flat = _program_params(params)
    key = json.dumps([model.name, repr(dataclasses.replace(model.cfg, flat_layout=False)),
                      model_toggle_kwargs(model),
                      [(k, list(v.shape), str(v.dtype)) for k, v in flat.items()]])
    with _PROGRAMS_LOCK:
        if key not in _PROGRAMS:
            try:
                _PROGRAMS[key] = _export_program(model, params, flat)
            except Exception as e:  # a failed export fails the same way next time
                _PROGRAMS[key] = e
        got = _PROGRAMS[key]
    if isinstance(got, Exception):
        raise got
    return got


def _export_program(model, params, flat: dict) -> bytes:
    import io

    traced = model.__class__(dataclasses.replace(model.cfg, flat_layout=False),
                             **model_toggle_kwargs(model))
    load_params(traced, params, "meta")
    fs = model.cfg.feature_set
    b = 4  # an example size that is not specialised (0 and 1 are)
    args = (flat, torch.zeros(b, fs.num_fields, dtype=torch.int32),
            torch.zeros(b, fs.num_numeric, dtype=torch.float32))
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        ep = torch.export.export(_Apply(traced).eval(), args,
                                 dynamic_shapes=({k: None for k in flat}, {0: batch},
                                                 {0: batch}))
    ep._example_inputs = None  # the weights live in arrays.npz only
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_model(
    params,
    model,
    job_dir: str | Path,
    step: int,
    exports_to_keep: int = 5,
    row_perm=None,
) -> Path:
    """Write ``params`` (a rectpu-layout tree of tensors or arrays) under
    <job_dir>/export/exporter/<ts>/ and prune old exports. ``row_perm``, the
    row relabelling training applied, is written beside them as
    ``row_perm.npy`` (int32) and marked ``row_placement`` in model.json, so
    that serving encodes with the same map (``rectpu/serve/export.py:155-158``)."""
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
        if row_perm is not None:
            np.save(tmp / "row_perm.npy", np.asarray(row_perm, dtype=np.int32))
            meta["row_placement"] = True
        try:
            (tmp / PROGRAM).write_bytes(_serialized_apply_bytes(model, params))
            meta["serialized_apply_torch"] = True
        except Exception as e:  # recorded, as rectpu records a failed jax.export
            logger.warning("torch.export serialization skipped: %s",
                           str(e).splitlines()[0] if str(e) else type(e).__name__)
            meta["serialized_apply_torch"] = False
            meta["serialized_apply_torch_error"] = f"{type(e).__name__}: {e}"[:500]
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


def make_exporter(model, job_dir: str | Path, exports_to_keep: int = 5, row_perm=None,
                  mode: str = "latest", compare_metric: str = "auc"):
    """The Trainer's exporter callback ``exporter(params, step, metrics=None)``
    (``rectpu/serve/export.py:381-432``).

    ``mode="latest"`` exports after every eval (tf.estimator's
    LatestExporter). ``mode="best"`` is its BestExporter: export only when
    ``metrics[compare_metric]`` improves on the best so far, kept across
    restarts in ``<job_dir>/best_metric.json`` as ``{compare_metric: value,
    "step": step}``; for ``average_loss`` and ``loss`` lower is better, for
    every other metric higher. Either way the newest ``exports_to_keep``
    exports are kept."""
    if not isinstance(model.cfg.activation, str):
        # fail when the trainer is built, not at the first export
        raise ValueError(
            "export requires a string activation (got a callable); register "
            "it by name in models.base.get_activation"
        )
    if mode not in ("latest", "best"):
        raise ValueError(f"unknown exporter mode {mode!r}")
    best_path = Path(job_dir) / "best_metric.json"
    lower_is_better = compare_metric in ("average_loss", "loss")

    def exporter(params, step, metrics=None):
        if mode == "best":
            if not metrics or compare_metric not in metrics:
                logger.warning("best exporter: no %r in eval metrics, skipping export",
                               compare_metric)
                return
            value = float(metrics[compare_metric])
            prev = None
            if best_path.exists():
                prev = json.loads(best_path.read_text()).get(compare_metric)
            if prev is not None and not (value < prev if lower_is_better else value > prev):
                logger.info("best exporter: %s=%.6f did not improve on %.6f, skipping export",
                            compare_metric, value, prev)
                return
            logger.info("best exporter: %s improved %s -> %.6f, exporting", compare_metric,
                        "None" if prev is None else f"{prev:.6f}", value)
        export_model(params, model, job_dir, step, exports_to_keep, row_perm=row_perm)
        if mode == "best":
            tmp = best_path.with_suffix(".tmp")
            tmp.write_text(json.dumps({compare_metric: value, "step": step}))
            tmp.replace(best_path)

    return exporter


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

    def encode_request(self, features: dict, use_native: bool = True) -> dict:
        """Validate + encode raw serving features to dense model arrays
        (``use_native=False``: the Python FarmHash, the plain version).

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
        batch = self.feature_set.encode(columns, use_native)
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


class SerializedApply(torch.nn.Module):
    """A loaded ``apply.pt2`` program with its parameters on one device: the
    ``model`` of a ServingModel that serves the program. Neither is a
    submodule, so ``.to()`` and ``.eval()`` leave them as they are."""

    def __init__(self, program, params: dict):
        super().__init__()
        object.__setattr__(self, "_program", program)
        object.__setattr__(self, "_params", params)

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor) -> torch.Tensor:
        return self._program(self._params, cat_ids, num_vals)


def _load_program(path: Path, params, device) -> SerializedApply:
    """The program at ``path`` on ``device`` with ``params`` (a rectpu-layout
    tree) as its inputs."""
    ep = torch.export.load(path)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)  # devices traced in as constants
    flat = {k: v.to(device) for k, v in _program_params(params).items()}
    return SerializedApply(ep.module(), flat)


def load_model(export_dir: str | Path, use_serialized: bool = False,
               device=None) -> ServingModel:
    """Rebuild a ServingModel from an export directory (rectpu's or the
    port's), on ``device`` (default ``cuda``).

    ``use_serialized=True`` runs the export's ``apply.pt2`` program instead
    of the model's Python code; an export without one raises
    ``FileNotFoundError``, and an int8-quantized export raises
    ``ValueError`` (its program was dropped with the float table)."""
    device = resolve_device(device)
    export_dir = Path(export_dir)
    meta = json.loads((export_dir / "model.json").read_text())
    if use_serialized:
        if meta.get("table_quant") == "int8":
            raise ValueError("quantized exports carry no serialized program (it was traced "
                             "over float params); load without use_serialized")
        if not (meta.get("serialized_apply_torch") and (export_dir / PROGRAM).exists()):
            # every export rectpu wrote, and one whose torch.export failed
            raise FileNotFoundError(f"no serialized apply program ({PROGRAM}) in {export_dir}")
    params = _rebuild(meta["template"], _load_flat_npz(export_dir / "arrays.npz"))
    tc = meta["tower_config"]
    feature_set = ml_100k_feature_set(numeric=tuple(meta.get("numeric_features", ())))
    row_perm = None
    if meta.get("row_placement"):
        row_perm = np.load(export_dir / "row_perm.npy")
    if use_serialized:
        return ServingModel(_load_program(export_dir / PROGRAM, params, device), feature_set,
                            row_perm=row_perm, device=device)
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
    load_params(model, params, device)
    return ServingModel(model, feature_set, row_perm=row_perm, device=device)
