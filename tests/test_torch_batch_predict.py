"""The port's batch prediction (``rectpu_torch/serve/batch_predict.py``)
against rectpu's ``rectpu/serve/batch_predict.py``.

rectpu reads each chunk with pandas, which turns a zipcode column whose
values are all numeric into int64: "03364" is hashed as "3364", unlike
rectpu's trainer and online server. The port keeps strings (a deliberate
deviation). So on a CSV whose zip codes have no leading zero the two
packages write the same records and metrics, and on one with leading zeros
the port equals rectpu's online ``ServingModel.predict`` on the same rows,
where rectpu's batch prediction differs. fp32 DeepFM; probabilities and
logits within 1e-5 (sums in another order).
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import DeepFMModel as JaxDeepFM
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.batch_predict import _exact_auc as jax_exact_auc
from rectpu.serve.batch_predict import batch_predict as jax_batch_predict
from rectpu.serve.export import export_model as jax_export_model
from rectpu.serve.export import load_model as jax_load_model
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.serve import batch_predict as bp
from rectpu_torch.serve.export import load_model


def _randomize(params, seed):
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = [jnp.asarray(rng.normal(0.0, 0.3 if ("emb" in jax.tree_util.keystr(p)
                                                  or "table" in jax.tree_util.keystr(p))
                                     else 0.1, np.shape(x)).astype(np.float32))
              for p, x in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("bp")
    files = write_synthetic_dataset(d / "data", train_rows=200, test_rows=300, seed=6)
    model = JaxDeepFM(JaxTowerConfig(feature_set=jax_feature_set(numeric=("action",)),
                                     embedding_size=4, hidden_units=(16,)))
    export = jax_export_model(_randomize(model.init(jax.random.PRNGKey(0)), 0), model,
                              d / "job", step=1)
    with open(files["test"], newline="") as f:
        rows = list(csv.reader(f))
    z = rows[0].index("zipcode")
    assert any(r[z].startswith("0") for r in rows[1:]), "the data must hold leading zeros"
    no_zero = d / "no_leading_zero.csv"
    with open(no_zero, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(rows[0])
        for r in rows[1:]:
            r = list(r)
            r[z] = str(10000 + int(r[z]) % 90000) if r[z].isdigit() else r[z]
            w.writerow(r)
    return {"export": export, "leading_zero": files["test"], "no_leading_zero": str(no_zero)}


def _records(path):
    return [json.loads(line) for line in open(path)]


def _same(got, want, keys=("probabilities", "logits")):
    assert len(got) == len(want)
    for k in keys:
        np.testing.assert_allclose([r[k] for r in got], [r[k] for r in want], atol=1e-5, rtol=0)
    assert [r["class_id"] for r in got] == [r["class_id"] for r in want]


@pytest.mark.parametrize("batch_size", [64, 1000])
def test_matches_rectpus_batch_predict_without_leading_zeros(setup, tmp_path, batch_size):
    kw = dict(batch_size=batch_size, include_inputs=("user_id", "zipcode", "rating"),
              label_col="rating")
    n, metrics = bp.batch_predict(load_model(setup["export"], device="cpu"),
                                  setup["no_leading_zero"], tmp_path / "port.jsonl", **kw)
    jn, jmetrics = jax_batch_predict(jax_load_model(setup["export"]),
                                     setup["no_leading_zero"], tmp_path / "ref.jsonl", **kw)
    assert n == jn == 300
    got, want = _records(tmp_path / "port.jsonl"), _records(tmp_path / "ref.jsonl")
    _same(got, want)
    assert [r["user_id"] for r in got] == [r["user_id"] for r in want]
    assert [r["rating"] for r in got] == [r["rating"] for r in want]
    # pandas made the column int64; the port keeps the CSV's text
    assert [r["zipcode"] for r in got] == [str(r["zipcode"]) for r in want]
    assert sorted(metrics) == sorted(jmetrics) == ["accuracy", "auc", "average_loss", "count"]
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], atol=1e-6, rtol=0)
    assert 0.0 <= metrics["auc"] <= 1.0


def test_leading_zeros_follow_the_online_server(setup, tmp_path):
    """The deviation: the port equals rectpu's online predict on the CSV's
    strings; rectpu's batch prediction, hashing 3364 for "03364", does not."""
    n, _ = bp.batch_predict(load_model(setup["export"], device="cpu"), setup["leading_zero"],
                            tmp_path / "port.jsonl", batch_size=128)
    jax_batch_predict(jax_load_model(setup["export"]), setup["leading_zero"],
                      tmp_path / "ref.jsonl", batch_size=128)
    with open(setup["leading_zero"], newline="") as f:
        rows = list(csv.DictReader(f))
    from rectpu.features.schema import GENRE

    ints = ["user_id", "item_id", "age", "release_year"] + [g for g in GENRE if g in rows[0]]
    cols = {k: np.array([int(r[k]) for r in rows], dtype=np.int64) for k in ints}
    for k in ("gender", "occupation", "zipcode"):
        cols[k] = np.array([r[k] for r in rows])
    online = jax_load_model(setup["export"]).predict(cols)
    got, ref = _records(tmp_path / "port.jsonl"), _records(tmp_path / "ref.jsonl")
    np.testing.assert_allclose([r["logits"] for r in got], online["logits"], atol=1e-5, rtol=0)
    zero = np.array([r["zipcode"].startswith("0") for r in rows])
    diff = np.abs(np.array([r["logits"] for r in ref]) - online["logits"])
    assert zero.any() and (diff[zero] > 1e-4).any()
    np.testing.assert_allclose(diff[~zero], 0.0, atol=1e-5)


def test_exact_auc_is_rectpus():
    rng = np.random.default_rng(3)
    for n in (1, 10, 257):
        scores = np.round(rng.random(n), 1)  # many ties
        labels = (rng.random(n) > 0.6).astype(np.float64)
        got, want = bp._exact_auc(scores, labels), jax_exact_auc(scores, labels)
        assert (np.isnan(got) and np.isnan(want)) or got == want


@pytest.mark.parametrize("flags", [[], ["--serialized"], ["--table-quant", "int8"]])
def test_cli_on_cpu(setup, tmp_path, flags):
    """The CLI on a port-written export (it carries apply.pt2): records and
    metrics files written; --serialized equals the Python model, int8 stays
    within rectpu's 0.02 of it."""
    from rectpu_torch.models import DeepFMModel, TowerConfig
    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.serve.export import export_model
    import torch

    model = DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=4,
                                    hidden_units=(16,)))
    export = export_model(model.init(torch.Generator().manual_seed(1)), model,
                          tmp_path / "job", step=1)
    args = ["--job-dir", str(tmp_path / "job"), "--input-csv", setup["leading_zero"],
            "--output", str(tmp_path / "out.jsonl"), "--device", "cpu", "--batch-size", "100",
            "--label-col", "rating", "--metrics-output", str(tmp_path / "m.json"),
            "--compilation-cache-dir", str(tmp_path / "cache"), *flags]
    n, metrics = bp.main(args)
    assert n == 300 and json.loads((tmp_path / "m.json").read_text()) == metrics
    got = _records(tmp_path / "out.jsonl")
    plain, _ = bp.batch_predict(load_model(export, device="cpu"), setup["leading_zero"],
                                tmp_path / "plain.jsonl", batch_size=300)
    want = _records(tmp_path / "plain.jsonl")
    if flags[:1] == ["--table-quant"]:
        np.testing.assert_allclose([r["probabilities"] for r in got],
                                   [r["probabilities"] for r in want], atol=0.02)
    else:
        _same(got, want)


def test_cli_requires_cuda_unless_cpu(setup, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bp.main(["--export-dir", str(setup["export"]), "--input-csv", setup["leading_zero"],
                 "--output", str(tmp_path / "o.jsonl")])
