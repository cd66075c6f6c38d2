"""Slice-level checks of the PyTorch port's serving path against rectpu.

rectpu writes an export (``rectpu.serve.export.export_model``) from
randomised DeepFM parameters; the port loads that directory as it is
(``device="cpu"``) and both packages' ``ServingModel.predict`` get the same
raw request. Every parameter leaf is random (rectpu initialises the linear
weights to zero, which would hide a wrong linear path).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import DeepFMModel as JaxDeepFM
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.export import export_model as jax_export_model
from rectpu.serve.export import load_model as jax_load_model
from rectpu_torch.serve.export import ServingModel, load_model

REPO = Path(__file__).resolve().parents[1]

# 8 requests in the reference serving schema: int and string ids, an
# out-of-vocabulary gender, a zipcode with a leading zero, ages and years on
# bucket boundaries, and genre flags given for some rows only (missing ones
# default to 0)
FEATURES = {
    "user_id": np.array([1, 7, 942, 55, 300, 12, 700, 3]),
    "item_id": np.array([10, 55, 1682, 1, 999, 250, 42, 7]),
    "age": np.array([25, 40, 15, 65, 33, 7, 51, 29]),
    "gender": np.array(["F", "M", "M", "F", "X", "M", "F", "M"]),
    "occupation": np.array(["student", "writer", "engineer", "none", "artist",
                            "doctor", "student", "other"]),
    "zipcode": np.array(["85711", "10027", "02139", "94043", "T8H1N", "60201",
                         "00000", "55105"]),
    "release_year": np.array([1994, 1987, 1930, 1997, 1960, 1990, 1979, 1995]),
    "action": np.array([1, 0, 1, 0, 0, 1, 0, 1]),
    "drama": np.array([0, 1, 1, 0, 1, 0, 0, 1]),
}


def _randomize(params, seed: int, emb_scale: float):
    """Every leaf random, in its own dtype: embeddings and the packed table at
    emb_scale, everything else at 0.1."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        scale = emb_scale if ("emb" in name or "table" in name) else 0.1
        arr = np.asarray(leaf)
        leaves.append(jnp.asarray(rng.normal(0.0, scale, arr.shape).astype(np.float32),
                                  arr.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _rectpu_export(tmp_path, seed=0, numeric=(), kwargs=None, emb_scale=0.1, **cfg):
    model = JaxDeepFM(JaxTowerConfig(feature_set=jax_feature_set(numeric=numeric), **cfg),
                      **(kwargs or {}))
    params = _randomize(model.init(jax.random.PRNGKey(seed)), seed, emb_scale)
    return jax_export_model(params, model, tmp_path, step=1)


CASES = {
    "k4_unpacked": dict(embedding_size=4, hidden_units=(16, 16)),
    "k4_packed": dict(embedding_size=4, hidden_units=(16, 16), packed_linear=True),
    "k4_unfused_no_dnn": dict(embedding_size=4, hidden_units=(16, 16),
                              fuse_linear_lookup=False, kwargs={"use_dnn": False}),
    "k4_no_linear": dict(embedding_size=4, hidden_units=(16, 16),
                         kwargs={"use_linear": False}),
    "k4_fm3_numeric": dict(embedding_size=4, hidden_units=(16, 16),
                           numeric=("action", "drama"), kwargs={"fm_order": 3}),
    "k64_packed": dict(embedding_size=64, hidden_units=(256, 128), packed_linear=True),
    "k64_unpacked": dict(embedding_size=64, hidden_units=(256, 128)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_predict_matches_rectpu(tmp_path, case):
    """fp32 logits agree to atol 1e-5 at K=4 and 1e-4 at K=64 (the FM and the
    1,664-wide first matmul sum in fp32 in another order); class_id is equal."""
    cfg = dict(CASES[case])
    d = _rectpu_export(tmp_path, seed=len(case), **cfg)
    want = jax_load_model(d).predict(dict(FEATURES))
    served = load_model(d, device="cpu")
    assert served.device == torch.device("cpu")
    got = served.predict(dict(FEATURES))
    atol = 1e-5 if cfg["embedding_size"] == 4 else 1e-4
    assert np.abs(want["logits"]).max() > 0.1  # the comparison is not of zeros
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(got["class_id"], want["class_id"])
    assert got["logits"].dtype == np.float32 and got["class_id"].dtype == np.int32


def test_bf16_predict_matches_rectpu_pallas(tmp_path):
    """bf16 towers at the flagship widths, exported with embedding_impl and
    fm_impl "pallas", so rectpu runs both Pallas kernels (interpret mode).
    Logits agree to atol 2e-2: the lookup and the FM agree exactly, but the
    bf16 hidden activations are rounded from fp32 sums taken in another
    order, and an activation that lands one bf16 ulp (2^-8 relative) apart
    moves the logit by about its weight times that ulp."""
    d = _rectpu_export(tmp_path, seed=5, emb_scale=0.05, embedding_size=64,
                       hidden_units=(256, 128), compute_dtype="bfloat16",
                       embedding_impl="pallas", fm_impl="pallas", packed_linear=True)
    want = jax_load_model(d).predict(dict(FEATURES))
    served = load_model(d, device="cpu")
    assert served.model.table.dtype == torch.float32  # the fp32 master, cast per gather
    got = served.predict(dict(FEATURES))
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=2e-2)


def test_http_predict_through_port_server(tmp_path):
    """One POST /predict to the port's server (micro-batching on, CPU), plus
    /healthz and /metrics; the response matches the port's own predict."""
    from rectpu_torch.serve.server import make_server

    _rectpu_export(tmp_path, seed=3, embedding_size=4, hidden_units=(16, 16))
    httpd, served = make_server(job_dir=str(tmp_path), port=0, device="cpu",
                                batch_window_ms=1.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        instances = [{k: v[i].item() for k, v in FEATURES.items()} for i in range(3)]
        del instances[2]["action"]  # missing genre flag -> 0
        req = urllib.request.Request(f"{base}/predict",
                                     data=json.dumps({"instances": instances}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            preds = json.loads(r.read())["predictions"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close()
        t.join(timeout=10)
    assert not t.is_alive()
    assert len(preds) == 3
    want = served.served.predict({k: [inst.get(k, 0) for inst in instances]
                                  for k in FEATURES})
    np.testing.assert_allclose([p["logits"] for p in preds], want["logits"], rtol=1e-6)
    assert [p["class_id"] for p in preds] == want["class_id"].tolist()
    assert metrics["requests_served"] == 1 and metrics["rows_dispatched"] == 3


def test_port_imports_neither_jax_nor_rectpu():
    """Every rectpu_torch module (the training slice's, the DLRM and
    xDeepFM slice's, the sparse fast step's and the autotuner's, timing's
    and profiling's, the Linear, DNN and Wide&Deep families', their trainer
    CLIs', the ml-100k ETL's, int8 serving's, batch prediction's and the
    native host library's, and the sharding modules of ``parallel/``
    among them), and chip_smoke.py, import without pulling in jax, any module of rectpu, or
    pandas (the machine with the card has none)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rectpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(rectpu_torch.__path__, 'rectpu_torch.')]\n"
        "need = {'rectpu_torch.ops.scatter_rows', 'rectpu_torch.ops.fused_adam',\n"
        "        'rectpu_torch.train.optimizers', 'rectpu_torch.train.loop',\n"
        "        'rectpu_torch.io.loader', 'rectpu_torch.data.synthetic',\n"
        "        'rectpu_torch.trainers.common', 'rectpu_torch.trainers.deep_fm',\n"
        "        'rectpu_torch.ops.interaction', 'rectpu_torch.ops.cin',\n"
        "        'rectpu_torch.models.dlrm', 'rectpu_torch.models.xdeep_fm',\n"
        "        'rectpu_torch.trainers.dlrm', 'rectpu_torch.trainers.xdeep_fm',\n"
        "        'rectpu_torch.ops.scatter_dma', 'rectpu_torch.train.sparse',\n"
        "        'rectpu_torch.train.fast_step', 'rectpu_torch.ops.autotune',\n"
        "        'rectpu_torch.utils.timing', 'rectpu_torch.utils.profiling',\n"
        "        'rectpu_torch.models.linear', 'rectpu_torch.models.dnn',\n"
        "        'rectpu_torch.models.wide_deep', 'rectpu_torch.trainers.linear',\n"
        "        'rectpu_torch.trainers.deep', 'rectpu_torch.trainers.linear_deep',\n"
        "        'rectpu_torch.data.ml_100k', 'rectpu_torch.serve.quant',\n"
        "        'rectpu_torch.serve.batch_predict', 'rectpu_torch.io.native',\n"
        "        'rectpu_torch.io.native.build', 'rectpu_torch.io.native.csv_bridge',\n"
        "        'rectpu_torch.parallel', 'rectpu_torch.parallel.mesh',\n"
        "        'rectpu_torch.parallel.collectives', 'rectpu_torch.parallel.plan',\n"
        "        'rectpu_torch.parallel.embedding_ep', 'rectpu_torch.parallel.placement',\n"
        "        'rectpu_torch.parallel.sparse_ep'}\n"
        "assert need <= set(mods) and len(mods) > 30, mods\n"
        "for name in mods: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'rectpu', 'pandas')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """Without a GPU and without an explicit device="cpu", the entry points
    raise instead of carrying on on the CPU."""
    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.models import DeepFMModel, TowerConfig
    from rectpu_torch.serve.export import export_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set()))
    d = export_model(model.init(torch.Generator().manual_seed(0)), model, tmp_path, step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel(model, model.cfg.feature_set)
    assert load_model(d, device="cpu").predict(dict(FEATURES))["logits"].shape == (8,)
