"""The port's row set (``rectpu_torch.ops.scatter_dma``) against rectpu's.

rectpu's ``scatter_rows_dma`` runs its Pallas ``_rmw_kernel`` in interpret
mode here (a few seconds a call, so only a few calls); the port's plain
version must equal it bit for bit, on every slab row: updated rows, rows
the update leaves alone and the pad rows. Cheaper cases hold the plain
version against ``.at[rows].set(mode="drop")``, rectpu's contract, over
fp32 and bf16 slabs and widths down to a [V, 1] leaf.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rectpu.ops.scatter_dma import scatter_rows_dma as jax_scatter_rows_dma
from rectpu_torch.ops.scatter_dma import (scatter_rows_dma, scatter_rows_dma_cuda,
                                          scatter_rows_dma_plain, set_rows)


def _rows(uniq, cap, sentinel):
    rows = np.full((cap,), sentinel, np.int32)
    rows[:uniq.shape[0]] = np.sort(uniq)
    return rows


def _case(name, rng):
    """(slab [Vp, C], rows [n], vals [n, C], v_valid or None)."""
    if name == "collisions":
        # every row of two 8-row windows, plus scattered singles
        v, c = 1024, 128
        uniq = np.unique(np.concatenate([np.arange(16, 24), np.arange(96, 104),
                                         rng.integers(0, v, size=40)])).astype(np.int32)
        rows, v_valid = _rows(uniq, 96, v), None
    elif name == "all_sentinels":
        v, c = 512, 128
        rows, v_valid = np.full((64,), v, np.int32), None
    else:  # odd width, v_valid below Vp - 256, sentinels past v_valid
        v, c = 1000, 65
        rows = _rows(np.unique(rng.integers(0, v, size=80)).astype(np.int32), 96, 1024)
        v_valid = v
    vp = 1024 if name == "odd_width" else v + 256
    slab = rng.standard_normal((vp, c)).astype(np.float32)
    vals = rng.standard_normal((rows.shape[0], c)).astype(np.float32)
    return slab, rows, vals, v_valid


@pytest.mark.parametrize("name", ["collisions", "all_sentinels", "odd_width"])
def test_plain_equals_rectpu_kernel_bitwise(name):
    slab, rows, vals, v_valid = _case(name, np.random.default_rng(len(name)))
    want = np.asarray(jax_scatter_rows_dma(jnp.asarray(slab), jnp.asarray(rows),
                                           jnp.asarray(vals), v_valid=v_valid,
                                           interpret=True))
    got_t = torch.from_numpy(slab.copy())
    out = scatter_rows_dma(got_t, torch.from_numpy(rows), torch.from_numpy(vals),
                           v_valid=v_valid)
    assert out is got_t  # in place, as rectpu aliases its output to the slab
    np.testing.assert_array_equal(got_t.numpy().view(np.int32), want.view(np.int32))
    if name == "all_sentinels":
        np.testing.assert_array_equal(got_t.numpy(), slab)


def test_rejects_missing_pad_rows():
    for fn, slab, rows, vals in (
            (jax_scatter_rows_dma, jnp.zeros((512, 128), jnp.float32),
             jnp.zeros((8,), jnp.int32), jnp.zeros((8, 128), jnp.float32)),
            (scatter_rows_dma, torch.zeros(512, 128), torch.zeros(8, dtype=torch.int32),
             torch.zeros(8, 128))):
        kw = {"interpret": True} if fn is jax_scatter_rows_dma else {}
        with pytest.raises(AssertionError, match="pad rows"):
            fn(slab, rows, vals, v_valid=510, **kw)
    with pytest.raises(AssertionError):
        scatter_rows_dma(torch.zeros(512, 128), torch.zeros(8, dtype=torch.int32),
                         torch.zeros(8, 64))


@pytest.mark.parametrize("v_rows", [515, 1020])
def test_rejects_slab_rows_not_a_multiple_of_8(v_rows):
    """rectpu asserts ``slab.shape[0] % 8 == 0``; the port raises too (a
    ValueError), with enough pad rows past v_valid that only this rule is
    broken."""
    with pytest.raises(AssertionError):
        jax_scatter_rows_dma(jnp.zeros((v_rows, 128), jnp.float32), jnp.zeros((8,), jnp.int32),
                             jnp.zeros((8, 128), jnp.float32), v_valid=256, interpret=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        scatter_rows_dma(torch.zeros(v_rows, 128), torch.zeros(8, dtype=torch.int32),
                         torch.zeros(8, 128), v_valid=256)
    # the same call on a slab of a multiple of 8 rows goes through
    scatter_rows_dma(torch.zeros(v_rows // 8 * 8, 128), torch.zeros(8, dtype=torch.int32),
                     torch.zeros(8, 128), v_valid=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [1, 65, 256])
def test_plain_equals_at_set_drop(dtype, width):
    """Against rectpu's contract, ``.at[rows].set(vals, mode="drop")`` below
    v_valid: rows at or past it (and negative ones) leave the slab alone."""
    rng = np.random.default_rng(width)
    vp, v_valid = 600, 500
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    slab = rng.standard_normal((vp, width)).astype(np_dt)
    rows = _rows(np.unique(rng.integers(0, v_valid, size=200)).astype(np.int32), 256, vp)
    rows[-3:] = [v_valid, v_valid + 50, vp + 9]  # dropped at or past v_valid
    vals = rng.standard_normal((rows.shape[0], width)).astype(np_dt)
    keep = rows < v_valid
    want = np.asarray(jnp.asarray(slab).at[jnp.asarray(rows[keep])].set(
        jnp.asarray(vals[keep]), mode="drop"))
    t_dt = getattr(torch, dtype)
    as_t = (lambda a: torch.from_numpy(a.view(np.int16)).view(t_dt)) if dtype == "bfloat16" \
        else torch.from_numpy
    got = scatter_rows_dma_plain(as_t(slab.copy()), torch.from_numpy(rows), as_t(vals),
                                 v_valid=v_valid)
    bits = np.int16 if dtype == "bfloat16" else np.int32
    np.testing.assert_array_equal(got.view(torch.int16 if dtype == "bfloat16"
                                           else torch.int32).numpy(), want.view(bits))


def test_set_rows_takes_every_row_below_the_slab_and_the_kernel_needs_cuda():
    """``set_rows`` (the port's ``.at[].set(mode="drop")``) with v_valid = V
    writes every valid row, a [V] leaf through its [V, 1] view included; the
    kernel's wrapper refuses CPU tensors instead of falling back."""
    w = torch.zeros(10)
    set_rows(w[:, None], torch.tensor([0, 9, 10], dtype=torch.int32),
             torch.tensor([[1.0], [2.0], [3.0]]), 10)
    assert w.tolist() == [1.0] + [0.0] * 8 + [2.0]
    with pytest.raises(ValueError, match="v_valid"):
        set_rows(torch.zeros(4, 2), torch.zeros(1, dtype=torch.int32), torch.zeros(1, 2), 5)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows_dma_cuda(torch.zeros(16, 4), torch.zeros(2, dtype=torch.int32),
                              torch.zeros(2, 4), v_valid=8)
