"""The port's serialized program (``apply.pt2``, ``torch.export``), the
counterpart of rectpu's ``apply.jaxexport``.

Every family's export carries a program except AutoInt's grouped
attention, whose ``batch % att_group`` branch cannot hold for a dynamic
batch: that export records the error in ``model.json`` as rectpu records a
failed ``jax.export``. The program runs the registered forward ops
(``rectpu_torch::gather``, ``::fm_cross``, ``::interact``, ``::cin``; their
plain versions on the CPU), takes the parameters as inputs (the file holds
no weights) and serves any batch size: its predictions equal the eager
model's (the same functions in the same order: atol 1e-6 in fp32, 1e-3 on
logits in bf16, one bf16 ulp of a hidden activation at most moved by its
weight, where eager and traced casts may fuse differently).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_quant import CASES, FEATURES, _port_export, _rectpu_export
from rectpu_torch.serve.export import load_model

SERIALIZED_CASES = dict(CASES)
SERIALIZED_CASES.pop("autoint_grouped")  # its export records the failure (below)

OPS = {
    "deep_fm": {"gather", "fm_cross"}, "dlrm": {"gather", "interact"},
    "xdeep_fm": {"gather", "cin"}, "deep": {"gather"}, "linear_deep": {"gather"},
    "dcn": {"gather"}, "linear": {"gather"},
}


def _program(path):
    """(the registered ops the program calls, its lifted tensors)."""
    ep = torch.export.load(path)
    ops = {str(n.target).split(".")[1] for n in ep.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("rectpu_torch.")}
    return ops, {**ep.state_dict, **ep.constants}, ep.example_inputs


@pytest.mark.parametrize("case", list(SERIALIZED_CASES))
def test_program_matches_the_eager_model(case, tmp_path):
    d = _port_export(case, tmp_path, seed=3)
    meta = json.loads((d / "model.json").read_text())
    assert meta["serialized_apply_torch"] is True and meta["serialized_apply"] is False
    assert "serialized_apply_torch_error" not in meta
    ops, lifted, example = _program(d / "apply.pt2")
    assert OPS[CASES[case][0]] <= ops
    # the parameters are inputs and the example inputs are dropped: the file
    # holds no weight (at most a constant of a few elements)
    assert example is None and all(t.numel() <= 64 for t in lifted.values()), lifted.keys()
    eager = load_model(d, device="cpu")
    program = load_model(d, use_serialized=True, device="cpu")
    bf16 = CASES[case][1].get("compute_dtype") == "bfloat16"
    for n in (1, 12, 5):
        feats = {k: v[:n] for k, v in FEATURES.items()}
        got, want = program.predict(feats), eager.predict(feats)
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=1e-3 if bf16 else 1e-6)
        np.testing.assert_array_equal(got["class_id"], want["class_id"])


def test_grouped_autoint_records_the_failed_export(tmp_path):
    d = _port_export("autoint_grouped", tmp_path)
    meta = json.loads((d / "model.json").read_text())
    assert meta["serialized_apply_torch"] is False
    assert meta["serialized_apply_torch_error"]
    assert not (d / "apply.pt2").exists()
    with pytest.raises(FileNotFoundError, match="apply.pt2"):
        load_model(d, use_serialized=True, device="cpu")
    assert np.isfinite(load_model(d, device="cpu").predict(dict(FEATURES))["logits"]).all()


def test_rectpu_export_has_no_program(tmp_path):
    d = _rectpu_export("deep_fm_fused", tmp_path)
    assert (d / "apply.jaxexport").exists()
    with pytest.raises(FileNotFoundError, match="apply.pt2"):
        load_model(d, use_serialized=True, device="cpu")


def test_int8_export_refuses_the_program(tmp_path):
    from rectpu_torch.serve.quant import quantize_export

    d = _port_export("dlrm", tmp_path)
    quantize_export(d)
    with pytest.raises(ValueError, match="no serialized program"):
        load_model(d, use_serialized=True, device="cpu")


def test_eager_path_does_not_record_the_ops(tmp_path, monkeypatch):
    """The registered ops are for tracing only: an eager forward calls the
    wrappers directly."""
    from rectpu_torch.ops import embedding, fm

    calls = []
    monkeypatch.setattr(embedding, "gather_op", lambda *a: calls.append("gather"))
    monkeypatch.setattr(fm, "fm_cross_op", lambda *a: calls.append("fm"))
    d = _port_export("deep_fm_fused", tmp_path)
    load_model(d, device="cpu").predict(dict(FEATURES))
    assert calls == []


def test_server_serialized_over_http(tmp_path):
    from rectpu_torch.serve.server import make_server

    d = _port_export("xdeep_fm", tmp_path)
    httpd, served = make_server(export_dir=str(d), port=0, device="cpu", use_serialized=True,
                                batch_window_ms=1.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        rows = [{k: v[i].item() for k, v in FEATURES.items()} for i in range(7)]
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=json.dumps({"instances": rows}).encode())
        preds = json.loads(urllib.request.urlopen(req, timeout=60).read())["predictions"]
    finally:
        httpd.shutdown()
        t.join()
        served.close()
    want = load_model(d, device="cpu").predict({k: v[:7] for k, v in FEATURES.items()})
    np.testing.assert_allclose([p["logits"] for p in preds], want["logits"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags", [["--serialized"], ["--table-quant", "int8"]])
def test_server_cli_flags(flags, tmp_path):
    """``python -m rectpu_torch.serve.server --device cpu`` with each flag
    answers a request as the same model in this process does; the command
    line also carries rectpu's ``--compilation-cache-dir``, which the port's
    server accepts and ignores."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from rectpu_torch.serve.quant import quantize_serving

    d = _port_export("dlrm", tmp_path)
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rectpu_torch.serve.server", "--export-dir", str(d),
         "--device", "cpu", "--port", "0", "--batch-window-ms", "0",
         "--compilation-cache-dir", "", *flags],
        cwd=repo, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:  # the server logs its address once it listens
            if "listening on http://127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split("/")[0])
                break
        assert port, "the server did not start"
        rows = [{k: v[i].item() for k, v in FEATURES.items()} for i in range(4)]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=json.dumps({"instances": rows}).encode())
        preds = json.loads(urllib.request.urlopen(req, timeout=60).read())["predictions"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    want = load_model(d, device="cpu")
    if flags[0] == "--table-quant":
        want = quantize_serving(want)
    want = want.predict({k: v[:4] for k, v in FEATURES.items()})
    np.testing.assert_allclose([p["logits"] for p in preds], want["logits"], rtol=0, atol=1e-6)
