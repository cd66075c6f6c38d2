"""The launch plans of the FM-backward and lookup kernels, and the functions
they compute, against rectpu.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What they do with shapes, strides and addresses
is pure Python here: ``fm_bwd_plan`` / ``fm_bwd_windows`` (the staged row
tiles of ``fm.cu``'s backward: which bytes each bulk copy moves and where
they land) and ``lookup_plan`` (``embedding_lookup.cu``'s path, rows a tile,
lanes a row). These tests replay the kernels' address and counter arithmetic
in numpy on the plans, so a plan that would read outside a view, skip a row
or misplace a value fails on the CPU. The functions themselves are held
against rectpu's Pallas kernels in interpret mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.ops.embedding import lookup_pallas
from rectpu.ops.fm import fm_cross_pallas
from rectpu_torch.ops import embedding as t_emb
from rectpu_torch.ops import fm as t_fm
from rectpu_torch.train.checkpoint import to_tensor

ALLOC = 512  # PyTorch's caching allocator hands out blocks of this granularity
BF16_ULP = 2.0 ** -7


def _views(b: int, k: int, dtype: torch.dtype) -> dict:
    """The views the FM backward is handed: the model's looked[..., :K], the
    contiguous [B, F+2, K] of numeric fields, a view whose start is not
    16-byte aligned, and one whose rows are not one span. Only their
    strides, offsets and storage sizes are read, so the memory is never
    touched."""
    looked = torch.empty(b + 1, 26, k + 1, dtype=dtype)
    return {"strided": looked[:b, :, :k], "contiguous": torch.empty(b, 28, k, dtype=dtype),
            "offset": looked[1:, :, :k],
            "every_other": torch.empty(2 * b, 26, k + 1, dtype=dtype)[::2, :, :k]}


def _decode(e: np.ndarray, f: int, k: int):
    q, kk = np.divmod(e, k)
    r, ff = np.divmod(q, f)
    return r, ff, kk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4, 64])
@pytest.mark.parametrize("b", [1, 7, 37, 8192])
def test_fm_bwd_plan_stages_every_value_once(b, k, dtype):
    """Each tile's copies are 16-byte aligned, stay within 15 bytes of the
    view's bytes, inside its allocation and inside the stage; the tiles
    cover every row once; and where the kernel looks for v[b, f, k] in the
    stage (``row_at(r) + f * sf + k * es``) lies the copy of exactly that
    value's bytes (replayed for every tile, or a sample of 5 at B=8192).
    Non-span views take one copy a row."""
    for name, v in _views(b, k, dtype).items():
        es = v.element_size()
        base = 7 * ALLOC  # a block start of the allocator
        addr = base + v.storage_offset() * es
        alloc_end = base + -(-v.untyped_storage().nbytes() // ALLOC) * ALLOC
        f = v.shape[1]
        plan = t_fm.fm_bwd_plan(b, f, k, v.stride(0), v.stride(1), es)
        assert plan.mode == ("rows" if name == "every_other" and b > 1 else "span"), plan
        assert plan.smem_bytes <= t_fm.BWD_SMEM_TWO
        assert plan.vec == 1 and (plan.rows_per_tile * f * k * es) % 16 == 0
        tiles = t_fm.fm_bwd_windows(plan, b, f, k, es, addr)
        assert len(tiles) == plan.n_tiles == math.ceil(b / plan.rows_per_tile)
        covered = np.zeros(b, np.int64)
        sb, sf = plan.stride_b * es, plan.stride_f * es
        row_bytes = (f - 1) * sf + k * es
        replay = set(range(len(tiles))) if len(tiles) <= 40 else {0, 1, len(tiles) // 2,
                                                                   len(tiles) - 2, len(tiles) - 1}
        for t, copies in enumerate(tiles):
            b0 = t * plan.rows_per_tile
            rows = min(plan.rows_per_tile, b - b0)
            covered[b0:b0 + rows] += 1
            for lo, n, at in copies:
                assert lo % 16 == 0 and n % 16 == 0 and at % 16 == 0
                assert at + n <= plan.stage_bytes
                assert base <= lo and lo + n <= alloc_end
            # the widened windows reach at most 15 bytes past the view's bytes
            first = addr + b0 * sb
            if plan.mode == "span":
                (lo, n, _), = copies
                assert first - 15 <= lo <= first
                end = first + (rows - 1) * sb + row_bytes
                assert end <= lo + n <= end + 15
            else:
                assert len(copies) == rows
                for r, (lo, n, _) in enumerate(copies):
                    assert first + r * sb - 15 <= lo <= first + r * sb
                    assert lo + n - 15 <= first + r * sb + row_bytes <= lo + n
            if t not in replay:
                continue
            r, ff, kk = _decode(np.arange(rows * f * k), f, k)
            if plan.mode == "span":
                row_at = first % 16 + r * sb
            else:
                row_at = r * plan.slot_bytes + (first + r * sb) % 16
            off = row_at + ff * sf + kk * es  # where the kernel reads the value
            starts = np.array([at for _, _, at in copies])
            which = np.searchsorted(starts, off, side="right") - 1
            lo_, n_, at_ = (np.array(c)[which] for c in zip(*copies))
            assert (off + es <= at_ + n_).all()
            np.testing.assert_array_equal(lo_ + off - at_,
                                          addr + (b0 + r) * sb + ff * sf + kk * es)
        np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("f,k,es", [(26, 64, 2), (26, 64, 4), (26, 4, 2), (27, 4, 2),
                                    (26, 100, 2), (28, 5, 4)])
def test_fm_bwd_store_counters_follow_the_outputs(f, k, es):
    """Phase 2 of the kernel: thread t writes outputs e = t*V, t*V + 256*V,
    ... of a tile and carries (row, field, column) by fixed steps; the
    counters must equal the output's own coordinates."""
    v_el = 16 // es
    threads, tb = t_fm.BWD_THREADS, 16
    n_out = tb * f * k
    r0, f0, k0 = _decode(np.arange(threads) * v_el, f, k)
    dr, df, dk = _decode(np.array(threads * v_el), f, k)
    r, ff, kk = r0.copy(), f0.copy(), k0.copy()
    e = np.arange(threads) * v_el
    while (e < n_out).any():
        wr, wf, wk = _decode(e, f, k)
        live = e < n_out
        np.testing.assert_array_equal(np.stack([r, ff, kk])[:, live],
                                      np.stack([wr, wf, wk])[:, live])
        kk = kk + dk
        carry = kk >= k
        kk, ff = kk - k * carry, ff + carry
        ff = ff + df
        carry = ff >= f
        ff, r = ff - f * carry, r + carry + dr
        e = e + threads * v_el


def test_fm_bwd_plan_routes_wide_rows_to_the_direct_mode():
    """A row wider than a stage is not staged; a size-1 batch or field takes
    the packed stride."""
    assert t_fm.fm_bwd_plan(5, 26, 3000, 26 * 3000, 3000, 4).mode == "direct"
    one = t_fm.fm_bwd_plan(1, 26, 64, 0, 65, 2)
    assert one.mode == "span" and one.stride_b == 26 * 65 and one.n_tiles == 1


def q_rows(width: int, out_bytes: int) -> int:
    """The fewest rows whose output is a 16-byte multiple."""
    return 16 // math.gcd(width * out_bytes, 16)


@pytest.mark.parametrize("width", [1, 5, 65, 128, 256])
@pytest.mark.parametrize("in_bytes,out_bytes", [(4, 4), (2, 2), (4, 2)])
def test_lookup_plan(width, in_bytes, out_bytes):
    """The vector path exactly when both row widths are 16-byte multiples,
    its lane groups covering a row's 16-byte chunks and its grid every row;
    otherwise tiles whose output span is a 16-byte multiple, within the
    shared memory a block may take, whose (row, column-chunk) pairs write
    every element of a tile once."""
    for n_ids in (1, 7 * 26, 37 * 26, 4096 * 26):
        plan = t_emb.lookup_plan(n_ids, width, in_bytes, out_bytes)
        vec = (width * in_bytes) % 16 == 0 and (width * out_bytes) % 16 == 0
        assert (plan.path == "vector") == vec
        if vec:
            chunks = width * out_bytes // 16
            lanes = plan.param
            assert lanes & (lanes - 1) == 0 and lanes <= 32
            assert lanes >= chunks or lanes == 32
            rows_per_block = 32 // lanes * t_emb.VEC_ROWS * t_emb.LOOKUP_THREADS // 32
            assert plan.blocks == math.ceil(n_ids / rows_per_block)
            continue
        assert plan.path == "tile"
        rows = plan.param
        assert rows % q_rows(width, out_bytes) == 0 and rows <= t_emb.LOOKUP_THREADS
        assert plan.blocks == math.ceil(n_ids / rows)
        assert plan.smem_bytes <= t_emb.TILE_SMEM_MAX
        assert plan.smem_bytes >= -(-rows * 4 // 16) * 16 + rows * width * out_bytes
        # the kernel's gather: pair p is row p // chunks, columns from
        # (p % chunks) * TILE_COLS, at most TILE_COLS of them
        chunks = -(-width // t_emb.TILE_COLS)
        assert rows * chunks <= t_emb.TILE_PAIRS * t_emb.LOOKUP_THREADS or \
            rows == q_rows(width, out_bytes)
        written = np.zeros((rows, width), np.int64)
        for p in range(rows * chunks):
            row, c0 = divmod(p, chunks)
            written[row, c0 * t_emb.TILE_COLS:(c0 + 1) * t_emb.TILE_COLS] += 1
        np.testing.assert_array_equal(written, 1)
    # a table that does not start on 16 bytes is not copied 16 bytes a lane
    assert t_emb.lookup_plan(100, 128, 4, 4, aligned=False).path == "tile"


def test_lookup_plan_rows_path_for_a_wide_unaligned_row():
    """An unaligned row too wide for a tile of shared memory takes a warp a
    row."""
    assert t_emb.lookup_plan(100, 100_001, 4, 4).path == "rows"
    assert t_emb.lookup_plan(100, 3001, 4, 4).path == "tile"


def test_lookup_gather_dtype_bfloat16_matches_lookup_pallas():
    """lookup(fp32 table, gather_dtype=bf16) rounds the gathered rows in the
    gather: bitwise rectpu's lookup_pallas on the cast table, out-of-range
    ids giving zero rows; the table gradient is the same fp32 sums as
    before (values exact in fp32, so any order gives the same bits)."""
    rng = np.random.default_rng(3)
    v, w = 300, 65
    table = rng.normal(0.0, 0.5, (v, w)).astype(np.float32)
    ids = rng.integers(0, v, (37, 26)).astype(np.int32)
    ids[0, :3] = [-1, v, v + 9]
    ref = lookup_pallas(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids), interpret=True)
    t_table = to_tensor(table).requires_grad_(True)
    got = t_emb.lookup(t_table, torch.from_numpy(ids), gather_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (37, 26, w)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    np.testing.assert_array_equal(
        t_emb.gather_rows(to_tensor(table), torch.from_numpy(ids), torch.bfloat16)
        .view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    g = rng.integers(-8, 9, (37, 26, w)).astype(np.float32) / 8
    got.backward(to_tensor(g).to(torch.bfloat16))
    want = np.zeros((v, w), np.float32)
    ok = (ids >= 0) & (ids < v)
    np.add.at(want, ids[ok], g[ok])
    assert t_table.grad.dtype == torch.float32
    np.testing.assert_array_equal(t_table.grad.numpy(), want)
    with pytest.raises(ValueError, match="float32 rows to bfloat16 only"):
        t_emb.gather_rows(to_tensor(table).to(torch.bfloat16), torch.from_numpy(ids),
                          torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["strided", "concatenated"])
def test_fm_backward_matches_pallas_at_a_ragged_batch(layout, dtype):
    """fm_cross_bwd_xla == jax.grad through rectpu's fm_cross_pallas (its
    _fm_bwd_kernel in interpret mode) at B=37, a multiple of no tile, on the
    model's strided view and on the concatenated [B, F+2, K] of numeric
    fields. Tolerance: an fp32 sum over fields in another order, 1e-5 of
    |g| * sum_f |v|; in bf16 plus one bf16 ulp of the value."""
    rng = np.random.default_rng(37)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    b, k = 37, 64
    if layout == "strided":
        full = np.asarray(jnp.asarray(rng.normal(0.0, 0.3, (b, 26, k + 1)).astype(np.float32),
                                      jdt))
        t_v = to_tensor(full)[..., :k]
        v = np.ascontiguousarray(full[..., :k])
    else:
        emb = rng.normal(0.0, 0.3, (b, 26, k)).astype(np.float32)
        num = rng.normal(0.0, 0.3, (b, 2, k)).astype(np.float32)
        v = np.asarray(jnp.asarray(np.concatenate([emb, num], axis=1), jdt))
        t_v = torch.cat([to_tensor(np.asarray(jnp.asarray(emb, jdt))),
                         to_tensor(np.asarray(jnp.asarray(num, jdt)))], dim=1)
        assert t_v.is_contiguous()
    g = jnp.asarray(rng.normal(size=(b,)).astype(np.float32), jdt)
    want = jax.grad(lambda x: jnp.sum(
        fm_cross_pallas(x, interpret=True).astype(jnp.float32) * g.astype(jnp.float32)))(
        jnp.asarray(v))
    got = t_fm.fm_cross_bwd_xla(t_v, to_tensor(np.asarray(g)))
    assert got.dtype == t_v.dtype and got.shape == t_v.shape
    want_f = np.asarray(want, np.float32)
    v64 = np.asarray(v, np.float64)
    scale = np.abs(np.asarray(g, np.float64))[:, None, None] * np.abs(v64).sum(1, keepdims=True)
    tol = 1e-5 * scale + (BF16_ULP * np.abs(want_f) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(got.float().numpy() - want_f) <= tol)
