"""Offline batch prediction over an export: the port of
``rectpu/serve/batch_predict.py`` (ML Engine batch-job parity).

    python -m rectpu_torch.serve.batch_predict --job-dir checkpoints/deep_fm \\
        --input-csv data/ml-100k/test.csv --output predictions.jsonl [--device cuda]

Reads the input CSV in chunks of ``--batch-size`` rows (the standard ``csv``
module with the training loader's rules, ``io.loader.columns_from_rows``; no
pandas), encodes each through the same serving schema as the online server
(genre flags optional, defaulting to 0) and runs one forward a chunk on the
card (``--device cuda``, the default; ``cpu`` runs the plain versions). It
writes ML-Engine-style JSON lines

    {"probabilities": p, "logits": l, "class_id": c}

plus the columns named by ``--include-inputs``. Other columns of the input
(rating, timestamp, ...) are ignored, so the ETL's CSVs can be scored as they
are. ``--label-col`` also evaluates offline: exact rank AUC, accuracy, mean
log-loss and the count. ``--table-quant int8`` and ``--serialized`` are the
online server's flags.

One deliberate difference from rectpu: string columns stay strings.
rectpu reads each chunk with ``pd.read_csv`` without string dtypes, so a
chunk whose zip codes are all numeric hashes "03364" as 3364, unlike its
trainer and its online server; the port hashes "03364" as they do.
"""

from __future__ import annotations

import csv
import itertools
import json
from argparse import ArgumentParser

import numpy as np

from rectpu_torch.features.schema import GENRE
from rectpu_torch.io.loader import columns_from_rows
from rectpu_torch.serve.export import SERVING_REQUIRED, latest_export, load_model
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _raw_column(rows, i) -> np.ndarray:
    """A column outside the serving schema as the CSV's values: int64 when
    every value is an integer, float64 when every value is a number, else
    strings (pandas' inference, without its missing-value NaN)."""
    vals = [r[i] if i < len(r) else "" for r in rows]
    for kind in (int, float):
        try:
            return np.array([kind(v) for v in vals])
        except ValueError:
            pass
    return np.array(vals, dtype=str)


def _json_value(v):
    return v.item() if isinstance(v, np.generic) else v


def batch_predict(served, input_csv, output_path, batch_size: int = 8192,
                  include_inputs: tuple = (), label_col: str | None = None,
                  cutoff: float = 5.0):
    """Score every row of ``input_csv``; returns ``(rows_written, metrics)``.

    ``label_col`` also evaluates against the labels (``value >= cutoff``, the
    training rule): exact rank AUC, accuracy and mean log-loss, the offline
    counterpart of the trainer's eval pass."""
    n_total = 0
    all_probs, all_labels = [], []
    with open(input_csv, newline="") as f, open(output_path, "w") as out:
        reader = csv.reader(f)
        header = next(reader)
        present = set(header)
        for c in SERVING_REQUIRED:
            if c not in present:
                raise ValueError(f"input csv missing required column {c!r}")
        if label_col is not None and label_col not in present:
            raise ValueError(f"input csv missing label column {label_col!r}")
        numeric = {fe.name for fe in served.feature_set.numeric}
        wanted = (SERVING_REQUIRED + [g for g in GENRE if g in present]
                  + [n for n in sorted(numeric) if n not in SERVING_REQUIRED])
        wanted = list(dict.fromkeys(wanted))
        while rows := list(itertools.islice(reader, batch_size)):
            floats = numeric | ({label_col} if label_col is not None else set())
            cols = columns_from_rows(header, rows, wanted + ([label_col] if label_col else []),
                                     floats)
            preds = served.predict({c: cols[c] for c in wanted})
            extra = {}
            for c in include_inputs:
                if c in cols:
                    extra[c] = cols[c]
                elif c in present:
                    extra[c] = _raw_column(rows, header.index(c))
                else:
                    raise ValueError(f"input csv has no column {c!r} to include")
            n = len(rows)
            for i in range(n):
                rec = {
                    "probabilities": float(preds["probabilities"][i]),
                    "logits": float(preds["logits"][i]),
                    "class_id": int(preds["class_id"][i]),
                }
                for c, v in extra.items():
                    rec[c] = _json_value(v[i])
                out.write(json.dumps(rec) + "\n")
            if label_col is not None:
                all_probs.append(np.asarray(preds["probabilities"], np.float64))
                all_labels.append((cols[label_col] >= cutoff).astype(np.float64))
            n_total += n
            logger.info("scored %d rows (total %d)", n, n_total)
    metrics = None
    if label_col is not None and n_total:
        p = np.concatenate(all_probs)
        y = np.concatenate(all_labels)
        metrics = {
            "auc": _exact_auc(p, y),
            "accuracy": float(((p > 0.5) == (y > 0.5)).mean()),
            "average_loss": float(-np.mean(
                y * np.log(np.clip(p, 1e-12, 1.0))
                + (1 - y) * np.log(np.clip(1 - p, 1e-12, 1.0)))),
            "count": float(n_total),
        }
        logger.info("offline eval: %s", metrics)
    return n_total, metrics


def _exact_auc(scores, labels) -> float:
    """Rank AUC with ties given their mean rank (rectpu's ``_exact_auc``)."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    for s in np.unique(scores):
        m = scores == s
        ranks[m] = ranks[m].mean()
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job-dir", default=None, help="job dir whose newest export to score with")
    ap.add_argument("--export-dir", default=None, help="explicit export directory")
    ap.add_argument("--input-csv", required=True,
                    help="rows to score (serving schema; extra columns ignored)")
    ap.add_argument("--output", required=True, help="output JSONL path")
    ap.add_argument("--batch-size", type=int, default=8192,
                    help="rows per forward (default: %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--serialized", action="store_true",
                    help="run the export's serialized program (apply.pt2)")
    ap.add_argument("--table-quant", choices=["int8"], default=None,
                    help="quantize the embedding table to int8 at load time")
    ap.add_argument("--include-inputs", nargs="*", default=[],
                    help="input columns to copy into each output record "
                         "(e.g. user_id item_id for joining)")
    ap.add_argument("--label-col", default=None,
                    help="also evaluate offline against this label column (binarized "
                         "as value >= --cutoff): exact AUC, accuracy, log-loss")
    ap.add_argument("--cutoff", type=float, default=5.0,
                    help="label binarization threshold (default: %(default)s, the "
                         "training rule rating >= 5)")
    ap.add_argument("--metrics-output", default=None,
                    help="write the offline eval metrics to this JSON path")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="rectpu's XLA cache flag: accepted, nothing to configure here")
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)
    if a.serialized and a.table_quant:
        raise ValueError("--serialized and --table-quant are mutually exclusive")
    export_dir = a.export_dir or latest_export(a.job_dir)
    if export_dir is None:
        raise FileNotFoundError(f"no export under {a.job_dir}/export/exporter")
    served = load_model(export_dir, use_serialized=a.serialized, device=a.device)
    served.max_batch = a.batch_size
    if a.table_quant == "int8":
        from rectpu_torch.serve.quant import quantize_serving

        served = quantize_serving(served)
    logger.info("scoring %s with %s on %s", a.input_csv, export_dir, served.device)
    n, metrics = batch_predict(served, a.input_csv, a.output, a.batch_size,
                               include_inputs=tuple(a.include_inputs),
                               label_col=a.label_col, cutoff=a.cutoff)
    logger.info("wrote %d predictions to %s", n, a.output)
    if metrics is not None and a.metrics_output:
        with open(a.metrics_output, "w") as f:
            json.dump(metrics, f)
    return n, metrics


if __name__ == "__main__":
    main()
