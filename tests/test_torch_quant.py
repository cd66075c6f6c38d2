"""The port's int8 serving (``rectpu_torch/serve/quant.py`` and the gather
kernel's int8 mode) against rectpu's ``rectpu/serve/quant.py``.

  - ``quantize_rows`` bit for bit rectpu's; the int8 gather's plain version
    (``dequant_take``) bit for bit rectpu's ``dequant_lookup`` followed by the
    cast to the compute dtype, in fp32 and bf16.
  - Every family quantized in memory (``quantize_serving``) on an export
    that rectpu wrote and on one the port wrote: the port's predictions
    against rectpu's quantized ``ServingModel`` on the same export, within
    1e-5 in fp32 (the same int8 values and scales, sums in another order)
    and 2e-2 on logits for a bf16 tower against rectpu's Pallas FM (one bf16
    ulp of an activation moved by its weight, as
    ``tests/test_torch_serving.py`` allows); and
    within rectpu's own 0.02 on probabilities of the unquantized model
    (``tests/test_quant.py``).
  - ``quantize_export`` both ways: rectpu quantizes and the port serves, the
    port quantizes (its CLI) and rectpu serves; the in-place swap, the
    idempotence and the flag conflicts of rectpu's tests.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.models import MODEL_REGISTRY as JAX_REGISTRY
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.serve.export import export_model as jax_export_model
from rectpu.serve.export import load_model as jax_load_model
from rectpu.serve.quant import dequant_lookup as jax_dequant_lookup
from rectpu.serve.quant import dequantize_rows as jax_dequantize_rows
from rectpu.serve.quant import quantize_export as jax_quantize_export
from rectpu.serve.quant import quantize_rows as jax_quantize_rows
from rectpu.serve.quant import quantize_serving as jax_quantize_serving
from rectpu_torch.convert import params_tree
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import MODEL_REGISTRY, TowerConfig
from rectpu_torch.ops.embedding import dequant_gather, dequant_take
from rectpu_torch.serve import quant
from rectpu_torch.serve.export import export_model, load_model

FEATURES = {
    "user_id": np.array([1, 7, 942, 55, 300, 12, 700, 3, 81, 640, 2, 99]),
    "item_id": np.array([10, 55, 1682, 1, 999, 250, 42, 7, 1200, 5, 64, 333]),
    "age": np.array([25, 40, 15, 65, 33, 7, 51, 29, 44, 19, 70, 36]),
    "gender": np.array(["F", "M", "M", "F", "X", "M", "F", "M", "F", "M", "F", "M"]),
    "occupation": np.array(["student", "writer", "engineer", "none", "artist", "doctor",
                            "student", "other", "lawyer", "writer", "retired", "none"]),
    "zipcode": np.array(["85711", "10027", "02139", "94043", "T8H1N", "60201", "00000",
                         "55105", "03364", "90210", "11111", "02138"]),
    "release_year": np.array([1994, 1987, 1930, 1997, 1960, 1990, 1979, 1995, 1950, 1998,
                              1922, 1985]),
    "action": np.array([1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0, 1]),
}

# name: (family, TowerConfig kwargs, model kwargs, numeric columns)
CASES = {
    "deep_fm_fused": ("deep_fm", dict(embedding_size=4, hidden_units=(16,)), {}, ()),
    "deep_fm_packed_numeric": ("deep_fm", dict(embedding_size=4, hidden_units=(16,),
                                               packed_linear=True), {}, ("action",)),
    "deep_fm_unfused": ("deep_fm", dict(embedding_size=4, fuse_linear_lookup=False), {}, ()),
    # rectpu's Pallas FM (interpret mode) sums in fp32 as the port's kernel
    # does; its XLA form rounds bf16 intermediates
    "deep_fm_bf16": ("deep_fm", dict(embedding_size=8, compute_dtype="bfloat16",
                                     fm_impl="pallas"), {}, ()),
    "deep": ("deep", dict(embedding_size=4, hidden_units=(16,)), {}, ()),
    "linear_deep": ("linear_deep", dict(embedding_size=4, hidden_units=(16,)), {}, ()),
    "dlrm": ("dlrm", dict(embedding_size=4, hidden_units=(16,)),
             dict(bot_hidden_units=(8,)), ("action",)),
    "xdeep_fm": ("xdeep_fm", dict(embedding_size=4, hidden_units=(16,)),
                 dict(cin_units=(3, 4)), ()),
    "xdeep_fm_kmajor_packed": ("xdeep_fm", dict(embedding_size=4, packed_linear=True),
                               dict(cin_units=(2,), cin_layout="kmajor"), ("action",)),
    "dcn": ("dcn", dict(embedding_size=4, hidden_units=(16,)), dict(low_rank=8), ()),
    "autoint_grouped": ("autoint", dict(embedding_size=8), dict(att_impl="grouped",
                                                                 att_group=4), ()),
    "linear": ("linear", dict(), {}, ()),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(params, seed: int):
    """Every leaf random in its own dtype (rectpu's zero linear weights would
    hide a wrong path): tables at 0.3, the rest at 0.1."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        scale = 0.3 if ("emb" in name or "table" in name) else 0.1
        arr = np.asarray(leaf)
        leaves.append(jnp.asarray(rng.normal(0.0, scale, arr.shape).astype(np.float32),
                                  arr.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _rectpu_export(case, path, seed=0):
    family, cfg, kw, numeric = CASES[case]
    model = JAX_REGISTRY[family](JaxTowerConfig(feature_set=jax_feature_set(numeric=numeric),
                                                **cfg), **kw)
    params = _randomize(model.init(jax.random.PRNGKey(seed)), seed)
    return jax_export_model(params, model, path, step=1)


def _port_export(case, path, seed=0):
    family, cfg, kw, numeric = CASES[case]
    model = MODEL_REGISTRY[family](TowerConfig(feature_set=ml_100k_feature_set(numeric=numeric),
                                               **cfg), **kw)
    tree = model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    from rectpu_torch.convert import flatten_tree
    from rectpu_torch.train.checkpoint import _rebuild, _treedef_template

    flat = {k: torch.from_numpy(rng.normal(0.0, 0.3 if k.startswith(("emb", "table")) else 0.1,
                                           tuple(v.shape)).astype(np.float32)).to(v.dtype)
            for k, v in flatten_tree(tree).items()}
    return export_model(_rebuild(_treedef_template(tree), flat), model, path, step=1)


def _close(got, want, case):
    if CASES[case][1].get("compute_dtype") == "bfloat16":
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_quantize_rows_is_rectpus_bit_for_bit():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(257, 9)).astype(np.float32) * rng.uniform(
        0.01, 10.0, size=(257, 1)).astype(np.float32)
    arr[13] = 0.0
    arr[20] = 1e-39  # subnormal values and scale
    q, s = quant.quantize_rows(arr)
    jq, js = jax_quantize_rows(arr)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))
    np.testing.assert_array_equal(quant.dequantize_rows(q, s), jax_dequantize_rows(jq, js))
    # a bf16 table quantizes from its fp32 values, as rectpu's np.asarray does
    tb = torch.from_numpy(arr).to(torch.bfloat16)
    jb = np.asarray(jnp.asarray(arr, jnp.bfloat16))
    for a, b in zip(quant.quantize_rows(tb), jax_quantize_rows(jb)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [1, 5, 65, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_gather_plain_is_rectpus_dequant_lookup_then_cast(width, dtype):
    rng = np.random.default_rng(width)
    table = (rng.normal(size=(300, width)) * rng.uniform(0.001, 30, size=(300, 1))).astype(
        np.float32)
    q, s = jax_quantize_rows(table)
    ids = rng.integers(0, 300, size=(17, 26)).astype(np.int32)
    want = jax_dequant_lookup({"q": jnp.asarray(q), "s": jnp.asarray(s)}, jnp.asarray(ids))
    want = np.asarray(want.astype(jnp.dtype(dtype)))
    tdtype = getattr(torch, dtype)
    got = dequant_gather(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(ids),
                         tdtype)
    assert got.dtype == tdtype and got.shape == (17, 26, width)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    got_bits = got.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
    np.testing.assert_array_equal(got_bits.view(bits), want.view(bits))
    # out-of-range ids give zero rows
    bad = torch.tensor([[-1, 300, 5]], dtype=torch.int32)
    out = dequant_take(torch.from_numpy(q), torch.from_numpy(s), bad, tdtype)
    assert not out[0, :2].any() and out[0, 2].float().abs().sum() > 0


@pytest.mark.parametrize("writer", ["rectpu", "port"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_predictions_match_rectpu(case, writer, tmp_path):
    d = (_rectpu_export if writer == "rectpu" else _port_export)(case, tmp_path)
    port = load_model(d, device="cpu")
    ref = jax_load_model(d)
    qport, qref = quant.quantize_serving(port), jax_quantize_serving(ref)
    if case == "linear":
        assert qport is port and qref is ref
        return
    leaf = qport.model.table if hasattr(qport.model, "table") else qport.model.emb
    assert leaf["q"].dtype == torch.int8 and not leaf["q"].requires_grad
    got, want = qport.predict(dict(FEATURES)), qref.predict(dict(FEATURES))
    _close(got["logits"], want["logits"], case)
    np.testing.assert_allclose(got["probabilities"], port.predict(dict(FEATURES))[
        "probabilities"], atol=0.02)


@pytest.mark.parametrize("case", ["deep_fm_fused", "dlrm", "xdeep_fm", "deep_fm_bf16"])
def test_quantize_export_interchange(case, tmp_path):
    """rectpu quantizes, the port serves; the port quantizes (its CLI, into
    another directory and in place), rectpu serves."""
    a = _rectpu_export(case, tmp_path / "a", seed=1)
    jax_quantize_export(a)
    meta = json.loads((a / "model.json").read_text())
    assert meta["table_quant"] == "int8"
    got = load_model(a, device="cpu").predict(dict(FEATURES))
    want = jax_load_model(a).predict(dict(FEATURES))
    _close(got["logits"], want["logits"], case)

    b = _rectpu_export(case, tmp_path / "b", seed=1)
    out = tmp_path / "b_int8"
    quant.main([str(b), "--out", str(out)])
    assert (b / "apply.jaxexport").exists() and not (out / "apply.jaxexport").exists()
    meta = json.loads((out / "model.json").read_text())
    assert meta["table_quant"] == "int8" and meta["serialized_apply"] is False
    want = jax_load_model(out).predict(dict(FEATURES))
    got = load_model(out, device="cpu").predict(dict(FEATURES))
    _close(got["logits"], want["logits"], case)
    np.testing.assert_allclose(got["logits"], load_model(a, device="cpu").predict(
        dict(FEATURES))["logits"], atol=0, rtol=0)

    c = _port_export(case, tmp_path / "c", seed=2)
    assert (c / "apply.pt2").exists()
    quant.quantize_export(c)  # in place
    assert not (c / "apply.pt2").exists() and not list(c.parent.glob(".*"))
    meta = json.loads((c / "model.json").read_text())
    assert meta["serialized_apply_torch"] is False
    _close(load_model(c, device="cpu").predict(dict(FEATURES))["logits"],
           jax_load_model(c).predict(dict(FEATURES))["logits"], case)


def test_double_quantization_is_noop(tmp_path):
    d = _port_export("deep_fm_fused", tmp_path)
    served = quant.quantize_serving(load_model(d, device="cpu"))
    assert quant.quantize_serving(served) is served  # idempotent in memory
    m, p, did = quant.quantize_params(served.model, params_tree(served.model))
    assert not did
    quant.quantize_export(d)
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_export(d)
    again = quant.quantize_serving(load_model(d, device="cpu"))
    assert np.all(np.isfinite(again.predict(dict(FEATURES))["probabilities"]))
    lin = _port_export("linear", tmp_path / "lin")
    with pytest.raises(ValueError, match="no embedding table"):
        quant.quantize_export(lin)


def test_serialized_and_quant_conflict(tmp_path):
    from rectpu_torch.serve.server import make_server

    with pytest.raises(ValueError, match="mutually exclusive"):
        make_server(export_dir=str(tmp_path), use_serialized=True, table_quant="int8",
                    device="cpu")
    d = _port_export("deep_fm_fused", tmp_path / "q")
    quant.quantize_export(d)
    with pytest.raises(ValueError, match="no serialized program"):
        load_model(d, use_serialized=True, device="cpu")


def test_server_table_quant_over_http(tmp_path):
    """``--table-quant int8`` on an unquantized export answers as the
    in-memory quantized model does."""
    from rectpu_torch.serve.server import make_server

    d = _port_export("xdeep_fm", tmp_path)
    httpd, served = make_server(export_dir=str(d), port=0, device="cpu", table_quant="int8",
                                batch_window_ms=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        rows = [{k: v[i].item() for k, v in FEATURES.items()} for i in range(5)]
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            data=json.dumps({"instances": rows}).encode())
        preds = json.loads(urllib.request.urlopen(req, timeout=60).read())["predictions"]
    finally:
        httpd.shutdown()
        t.join()
    want = quant.quantize_serving(load_model(d, device="cpu")).predict(
        {k: v[:5] for k, v in FEATURES.items()})
    np.testing.assert_allclose([p["logits"] for p in preds], want["logits"], rtol=1e-6)
    assert served.model.table["q"].dtype == torch.int8


def test_gather_entries_match_their_ctypes_signatures():
    """Each C entry of embedding_lookup.cu (the int8 one among them) takes as
    many parameters as its wrapper passes: a mismatch would only show on the
    card."""
    import re
    from pathlib import Path

    from rectpu_torch.ops import embedding

    text = (Path(embedding.__file__).parents[1] / "kernels" / "csrc"
            / "embedding_lookup.cu").read_text()
    for fn, (argtypes, _) in embedding._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
