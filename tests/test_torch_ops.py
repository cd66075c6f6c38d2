"""Op-level checks of the PyTorch port against rectpu's own Pallas kernels.

Each plain PyTorch version in ``rectpu_torch.ops`` (the function its CUDA
kernel computes, and what the port runs on CPU tensors) is held against the
rectpu Pallas kernel it replaces, run in interpret mode on the CPU, on the
same inputs made with numpy from a seed. The CUDA kernels themselves run only
on the card: ``chip_smoke.py`` holds them against these plain versions there.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.ops.embedding import lookup_pallas
from rectpu.ops.fm import fm_cross3_xla as jax_fm_cross3
from rectpu.ops.fm import fm_cross_pallas
from rectpu.train.checkpoint import _flatten as jax_flatten
from rectpu.train.checkpoint import _load_flat_npz as jax_load_flat_npz
from rectpu.train.checkpoint import _rebuild as jax_rebuild
from rectpu_torch.ops import embedding as t_emb
from rectpu_torch.ops import fm as t_fm
from rectpu_torch.train.checkpoint import _load_flat_npz, to_tensor

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """Raw bit patterns of a float32 / bfloat16 array or tensor, for bitwise compares."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_take_bitwise_matches_lookup_pallas(dtype):
    """Gather == the Pallas one-hot matmul, bit for bit, with ids outside
    [0, V) giving zero rows (both below the table and beyond its 128-row pad)."""
    np_dt, jnp_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    v, w = 300, 65
    table = rng.normal(0.0, 0.5, (v, w)).astype(np.float32).astype(np_dt)
    ids = rng.integers(0, v, (16, 26)).astype(np.int32)
    ids[0, :5] = [-1, -7, v, v + 50, 10**6]
    ref = lookup_pallas(jnp.asarray(table, jnp_dt), jnp.asarray(ids), interpret=True)
    t_table, t_ids = to_tensor(table), torch.from_numpy(ids)
    got = t_emb.lookup_take(t_table, t_ids)
    assert got.shape == (16, 26, w) and got.dtype == t_table.dtype
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert not got[0, :5].any()
    # the dispatcher takes the plain version for CPU tensors, whatever the impl
    for impl in t_emb.IMPLS:
        np.testing.assert_array_equal(_bits(t_emb.lookup(t_table, t_ids, impl=impl)),
                                      _bits(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [26, 28])  # 26 ml-100k fields, + 2 numeric fields
@pytest.mark.parametrize("k", [4, 64])
def test_fm_cross_xla_matches_fm_cross_pallas(k, f, dtype):
    """fp32: rtol 1e-5 of the magnitude of the summed terms,
    0.5 * sum_k(S_k^2 + Q_k). Both versions sum in fp32 in different orders,
    and the FM output is a difference of those two large sums that can cancel
    to near zero, so a tolerance relative to the output itself is
    ill-conditioned (rectpu's own XLA and Pallas forms differ by up to 3e-6
    on these inputs). bf16: the same bf16 output, since both sum in fp32 and
    round once to bf16."""
    np_dt, jnp_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(k * 100 + f)
    fused = rng.normal(0.0, 0.3, (16, f, k + 1)).astype(np.float32).astype(np_dt)
    v = fused[..., :k]
    ref = np.asarray(fm_cross_pallas(jnp.asarray(np.ascontiguousarray(v), jnp_dt),
                                     interpret=True))
    # the port receives the strided view looked[..., :K] of the fused gather
    t_v = to_tensor(fused)[..., :k]
    assert not t_v.is_contiguous()
    got = t_fm.fm_cross_xla(t_v)
    assert got.shape == (16,) and got.dtype == t_v.dtype
    if dtype == "float32":
        v64 = v.astype(np.float64)
        scale = 0.5 * ((v64.sum(1) ** 2) + (v64 ** 2).sum(1)).sum(-1)
        assert np.all(np.abs(got.numpy() - ref) <= 1e-5 * scale)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    for impl in t_fm.IMPLS:
        np.testing.assert_array_equal(_bits(t_fm.fm_cross(t_v, impl=impl)), _bits(got))


@pytest.mark.parametrize("k", [4, 64])
def test_fm_cross3_matches_rectpu(k):
    rng = np.random.default_rng(k)
    v = rng.normal(0.0, 0.3, (16, 28, k)).astype(np.float32)
    ref = np.asarray(jax_fm_cross3(jnp.asarray(v)))
    got = t_fm.fm_cross3_xla(torch.from_numpy(v)).numpy()
    # rtol 1e-5 of the magnitude of the power-sum terms (they cancel, as in
    # the order-2 test)
    v64 = np.abs(v.astype(np.float64))
    p1, p2, p3 = v64.sum(1), (v64 ** 2).sum(1), (v64 ** 3).sum(1)
    scale = ((p1 ** 3 + 3 * p1 * p2 + 2 * p3) / 6).sum(-1)
    assert np.all(np.abs(got - ref) <= 1e-5 * scale)


def test_impl_names_are_checked():
    table, ids = torch.zeros(4, 3), torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="embedding_impl"):
        t_emb.lookup(table, ids, impl="gather")
    with pytest.raises(ValueError, match="fm_impl"):
        t_fm.fm_cross(torch.zeros(2, 3, 4), impl="flat")


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper launches its kernel or raises: handed CPU tensors it
    raises rather than running the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        t_emb.lookup_cuda(torch.zeros(4, 3), torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        t_fm.fm_cross_cuda(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("k,group", [(1, 1), (4, 4), (5, 8), (64, 32), (65, 32)])
def test_fm_lanes_per_row(k, group):
    assert t_fm._lanes_per_row(k) == group


def _deep_fm_tree(table_dtype):
    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.models import DeepFMModel, TowerConfig

    cfg = TowerConfig(feature_set=ml_100k_feature_set(numeric=("age",)),
                      table_dtype=table_dtype)
    model = DeepFMModel(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def test_export_roundtrip_matches_rectpu_checkpoint_format(tmp_path):
    """The port's export_model writes the key paths and bf16 tagging of
    rectpu's _flatten; rectpu's _load_flat_npz/_rebuild read it back leaf for
    leaf, and the port's _load_flat_npz reads rectpu's own npz the same way."""
    from rectpu_torch.serve.export import export_model

    model, tree = _deep_fm_tree("bfloat16")
    assert tree["emb"].dtype == torch.bfloat16
    d = export_model(tree, model, tmp_path, step=3)
    meta = json.loads((d / "model.json").read_text())
    assert meta["serialized_apply"] is False and meta["model"] == "deep_fm"

    jax_tree = jax.tree.map(
        lambda t: np.asarray(t.float().numpy(), jnp.bfloat16) if t.dtype == torch.bfloat16
        else t.numpy(), tree)
    expected = jax_flatten(jax_tree)
    with np.load(d / "arrays.npz") as z:
        assert sorted(z.files) == sorted(expected)
        assert "emb__bf16__" in z.files
        for key in z.files:
            np.testing.assert_array_equal(z[key], expected[key])

    back = jax_rebuild(meta["template"], jax_load_flat_npz(d / "arrays.npz"))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jax_tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got) if got.dtype == jnp.bfloat16 else got,
                                      _bits(want) if want.dtype == jnp.bfloat16 else want)

    from rectpu_torch.serve.export import load_model

    served = load_model(d, device="cpu")  # the port reads its own export back
    assert served.model.emb.dtype == torch.bfloat16  # the bf16 master, as stored
    assert torch.equal(served.model.fused_table()[:, :4], tree["emb"])
    assert torch.equal(served.model.mlp[2]["kernel"], tree["mlp"][2]["kernel"])

    np.savez(tmp_path / "jax.npz", **expected)
    flat = _load_flat_npz(tmp_path / "jax.npz")
    assert flat["emb"].dtype == torch.bfloat16
    assert torch.equal(flat["emb"], tree["emb"])
    assert torch.equal(flat["mlp/1/kernel"], tree["mlp"][1]["kernel"])


def test_convert_packed_equals_unpacked():
    """Both tree forms carry across to the same fused [V, K+1] table, and the
    other parameters to the same leaves."""
    from rectpu_torch.convert import load_params, params_tree
    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.models import DeepFMModel, TowerConfig
    from rectpu_torch.models.base import pack_fused_table

    rng = np.random.default_rng(1)
    fs = ml_100k_feature_set()
    unpacked = DeepFMModel(TowerConfig(feature_set=fs))
    packed = DeepFMModel(TowerConfig(feature_set=fs, packed_linear=True))
    v = unpacked.cfg.padded_buckets
    emb = rng.normal(size=(v, 4)).astype(np.float32)
    w = rng.normal(size=(v,)).astype(np.float32)
    mlp = [{"kernel": rng.normal(size=s).astype(np.float32), "bias": np.zeros(s[1], np.float32)}
           for s in [(104, 16), (16, 16), (16, 1)]]
    load_params(unpacked, {"emb": emb, "linear": {"w": w, "b": np.float32(0.5)},
                                   "mlp": mlp}, "cpu")
    table = pack_fused_table(torch.from_numpy(emb), torch.from_numpy(w)).numpy()
    load_params(packed, {"table": table, "linear": {"b": np.float32(0.5)},
                                 "mlp": mlp}, "cpu")
    assert torch.equal(unpacked.fused_table(), packed.fused_table())
    a, b = params_tree(unpacked), params_tree(packed)
    assert torch.equal(a["linear"]["b"], b["linear"]["b"])
    for la, lb in zip(a["mlp"], b["mlp"]):
        assert la.keys() == lb.keys()
        for name in la:
            assert torch.equal(la[name], lb[name]), name
