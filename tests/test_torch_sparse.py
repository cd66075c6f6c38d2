"""The port's sparse row updates (``rectpu_torch.train.sparse``) against
rectpu's ``rectpu/train/sparse.py`` on the same inputs.

Bitwise where the arithmetic is the same operation by operation:
``dedupe_rows``' rows, its sums (both sides add each id's gradients one
after another in the order of a stable sort: XLA's CPU scatter-add walks its
updates in order, the port's plain ``index_add_`` too), ``adam_lr_t`` and the
lazy-Adam rows (the same fp32 elementwise operations, and for a bf16 slab the
same stochastic-rounding bits at the same ``sr_seed``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.train import sparse as jsp
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.train import sparse as tsp


def _ids(fs, b, rng):
    return np.stack([fs.offsets[f] + rng.integers(0, fs.field_sizes[f], b)
                     for f in range(fs.num_fields)], axis=1).astype(np.int32)


def _bits(x):
    x = x.detach().cpu() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _t(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("batch", [1, 64, 4096])
def test_unique_capacity_equals_rectpu(batch):
    fs = ml_100k_feature_set()
    r = batch * fs.num_fields
    assert tsp.unique_capacity(fs.field_sizes, batch, r) == \
        jsp.unique_capacity(jax_feature_set().field_sizes, batch, r)


def test_check_ids_in_field_ranges_raises_where_rectpu_does():
    fs = ml_100k_feature_set()
    ids = _ids(fs, 16, np.random.default_rng(0))
    tsp.check_ids_in_field_ranges(ids, fs.offsets, fs.field_sizes)
    tsp.check_ids_in_field_ranges(torch.from_numpy(ids), fs.offsets, fs.field_sizes)
    ids[3, 2] = fs.offsets[2] + fs.field_sizes[2]
    for fn in (tsp.check_ids_in_field_ranges, jsp.check_ids_in_field_ranges):
        with pytest.raises(ValueError, match="field 2: id .* outside"):
            fn(ids, fs.offsets, fs.field_sizes)


@pytest.mark.parametrize("num_out", [None, "capacity", 7])
def test_dedupe_rows_equals_rectpu_bitwise(num_out):
    """Rows bitwise; the fp32 sums bitwise too (the same sequential order on
    both sides). ``num_out`` 7 drops uniques past the output on both."""
    fs = ml_100k_feature_set()
    rng = np.random.default_rng(1)
    b = 64
    ids = _ids(fs, b, rng).reshape(-1)
    grads = rng.standard_normal((ids.shape[0], 5)).astype(np.float32)
    if num_out == "capacity":
        num_out = tsp.unique_capacity(fs.field_sizes, b, ids.shape[0])
    rows_j, sums_j = jsp.dedupe_rows(jnp.asarray(ids), jnp.asarray(grads), 6144, num_out)
    rows_t, sums_t = tsp.dedupe_rows(torch.from_numpy(ids), torch.from_numpy(grads), 6144,
                                     num_out)
    assert rows_t.dtype == torch.int32 and sums_t.dtype == torch.float32
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(_bits(sums_t), _bits(sums_j))


# (slab dtype, lane-padded, [V] leaf): the four layouts of the m|v slab
PACKED_CASES = {
    "fp32_tight": ("float32", False, False),
    "fp32_lane_padded": ("float32", True, False),
    "bf16_sr": ("bfloat16", True, False),
    "linear_leaf": ("float32", False, True),
}


@pytest.mark.parametrize("case,backend", [
    (case, backend) for case in PACKED_CASES for backend in ("xla", "dma")
    if not (PACKED_CASES[case][2] and backend == "dma")])  # a [V] leaf never takes dma
def test_sparse_adam_rows_packed_equals_rectpu_bitwise(case, backend):
    """Two lazy-Adam steps on the same rows, the second from the first's
    state; params and the whole m|v slab bitwise equal to rectpu's. The
    "dma" backend holds the port against rectpu's "xla" (its bitwise twin)
    to keep the interpreted kernel out of this test."""
    slab_dtype, padded, vec = PACKED_CASES[case]
    rng = np.random.default_rng(2)
    vp, v_valid, w = 640, 600, 5
    wp = 128 if padded else w
    params = rng.standard_normal((vp,) if vec else (vp, w)).astype(np.float32)
    mv_dt = jnp.bfloat16 if slab_dtype == "bfloat16" else jnp.float32
    mv = np.asarray(jnp.asarray(np.abs(rng.standard_normal((vp, 2 * (1 if vec else wp))))
                                * 1e-3, mv_dt))
    p_j, mv_j = jnp.asarray(params), jnp.asarray(mv)
    p_t, mv_t = _t(params), _t(mv)
    uniq = np.unique(rng.integers(0, v_valid, 90)).astype(np.int32)
    rows = np.full((128,), vp, np.int32)
    rows[:uniq.shape[0]] = uniq
    for t in (1, 2):
        g = rng.standard_normal((128,) if vec else (128, w)).astype(np.float32)
        lr_j = jsp.adam_lr_t(1e-3, jnp.asarray(t))
        lr_t = tsp.adam_lr_t(1e-3, t)
        assert np.float32(lr_t) == np.asarray(lr_j)
        seed = t if slab_dtype == "bfloat16" else None
        p_j, mv_j = jsp.sparse_adam_rows_packed(p_j, mv_j, jnp.asarray(rows), jnp.asarray(g),
                                                lr_j, v_valid=v_valid, sr_seed=seed)
        out = tsp.sparse_adam_rows_packed(p_t, mv_t, torch.from_numpy(rows),
                                          torch.from_numpy(g), lr_t, scatter_backend=backend,
                                          v_valid=v_valid, sr_seed=seed)
        assert out[0] is p_t and out[1] is mv_t  # in place
    np.testing.assert_array_equal(_bits(p_t), _bits(p_j))
    np.testing.assert_array_equal(_bits(mv_t), _bits(mv_j))
    if slab_dtype == "bfloat16":
        with pytest.raises(ValueError, match="sr_seed"):
            tsp.sparse_adam_rows_packed(p_t, mv_t, torch.from_numpy(rows),
                                        torch.from_numpy(g), lr_t)


def test_sparse_adam_rows_equals_rectpu_and_leaves_untouched_rows():
    rng = np.random.default_rng(3)
    v, k = 50, 4
    p = rng.standard_normal((v, k)).astype(np.float32)
    m = (rng.standard_normal((v, k)) * 0.1).astype(np.float32)
    vv = (rng.random((v, k)) * 0.01).astype(np.float32)
    ids = np.array([3, 7, 3, 20], np.int32)
    g = rng.standard_normal((4, k)).astype(np.float32)
    rows_j, rg_j = jsp.dedupe_rows(jnp.asarray(ids), jnp.asarray(g), v)
    want = jsp.sparse_adam_rows(jnp.asarray(p), jnp.asarray(m), jnp.asarray(vv), rows_j, rg_j,
                                jsp.adam_lr_t(0.01, jnp.asarray(1)))
    rows_t, rg_t = tsp.dedupe_rows(torch.from_numpy(ids), torch.from_numpy(g), v)
    got = tsp.sparse_adam_rows(_t(p), _t(m), _t(vv), rows_t, rg_t, tsp.adam_lr_t(0.01, 1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(got[0].numpy()[untouched], p[untouched])
