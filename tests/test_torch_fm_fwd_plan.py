"""The FM forward kernels' launch plan and their order of sums, against rectpu.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
``fm_fwd_in_order`` and the plain version there). What they do with shapes,
strides and addresses is pure Python here: ``fm_fwd_plan`` picks the mode
(tiles staged in shared memory by one bulk copy a tile's span or one a row;
16-byte vectors read straight from device memory where every field's run
starts on 16 bytes; single values for what neither takes) and its grid, and
``fm_bwd_windows`` gives the bytes each staged tile copies and where they
land. These tests replay the kernels' address and index arithmetic in numpy
on the plans, so a plan that would read outside a view, read a pad column,
skip a value or read one twice fails on the CPU. Each kernel's order of sums
is replayed lane by lane in numpy against ``fm_fwd_in_order``, and the plain
version is held against rectpu's Pallas kernel in interpret mode.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.ops.fm import fm_cross_pallas
from rectpu_torch.ops import fm as t_fm
from rectpu_torch.train.checkpoint import to_tensor

ALLOC = 512  # PyTorch's caching allocator hands out blocks of this granularity
FM_RTOL_OF_SCALE = 1e-5  # fp32 sums in another order; relative to 0.5*sum_k(S^2+Q)
BF16_ULP = 2.0 ** -7
SMS = 132  # an H100's SMs
WARPS = t_fm.FWD_THREADS // 32


def _expected_mode(v: torch.Tensor) -> str:
    """The mode the plan must pick: 16-byte vectors when the view starts on
    16 bytes, every stride and a run of K values are 16-byte multiples, a
    run is at most 32 vectors and the fields carry pad between them; else a
    tile's span when the rows follow each other (after the size-1
    normalisation); else one copy a row."""
    b, f, k = v.shape
    es = v.element_size()
    sf = k if f == 1 else v.stride(1)
    sb = f * sf if b == 1 else v.stride(0)
    span = sb == f * sf and sf >= k
    aligned = (v.storage_offset() * es) % 16 == 0 and all(
        (n * es) % 16 == 0 for n in (k, sf, sb))
    if aligned and k * es // 16 <= 32 and not (span and sf == k):
        return "fields"
    return "span" if span else "rows"


def _views(b: int, k: int, dtype: torch.dtype) -> dict:
    """Each v the forward is handed: the model's looked[..., :K]; the fast
    step's looked[..., :K] of 2K columns (128 at K=64); the contiguous
    [B, F+2, K] of numeric fields; a start that is not 16-byte aligned; rows
    that are not one span, of either kind; one field. Only strides, offsets
    and storage sizes are read, so the memory is never touched."""
    looked = torch.empty(b + 1, 26, k + 1, dtype=dtype)
    padded = torch.empty(2 * b, 26, 2 * k, dtype=dtype)
    return {"strided": looked[:b, :, :k], "fast_step": padded[:b, :, :k],
            "contiguous": torch.empty(b, 28, k, dtype=dtype), "offset": looked[1:, :, :k],
            "every_other": torch.empty(2 * b, 26, k + 1, dtype=dtype)[::2, :, :k],
            "fast_step_every_other": padded[::2, :, :k],
            "one_field": torch.empty(b, 1, k + 1, dtype=dtype)[:, :, :k]}


def _plan(v: torch.Tensor, addr: int) -> "t_fm.FmFwdPlan":
    b, f, k = v.shape
    return t_fm.fm_fwd_plan(b, f, k, v.stride(0), v.stride(1), v.element_size(),
                            addr % 16 == 0, SMS)


def _phase1_writes(rows: int, k: int) -> np.ndarray:
    """How often phase 1 writes each (row, column) term of a tile: thread t
    takes pairs t, t + 256, ... four at a time while four remain, then one
    at a time."""
    n_sum, threads, sums = rows * k, t_fm.FWD_THREADS, 4
    writes = np.zeros(n_sum, np.int64)
    for tid in range(threads):
        p = tid
        while p + (sums - 1) * threads < n_sum:
            writes[p + threads * np.arange(sums)] += 1
            p += sums * threads
        while p < n_sum:
            writes[p] += 1
            p += threads
    return writes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4, 64, 100])
@pytest.mark.parametrize("b", [1, 7, 37, 512, 8192])
def test_fm_fwd_plan_reads_every_value_once(b, k, dtype):
    """For each view, the expected mode, and every value with k < K read
    exactly once and no pad column read. Staged: each tile's copies 16-byte
    aligned, inside the view's allocation and the stage, within 15 bytes of
    the view's bytes; the tiles cover every row once, blocks taking tiles j,
    j + blocks, ...; where the kernel looks for v[b, f, k] in the stage lies
    the copy of exactly that value's bytes (every tile, or 5 of them past 40)
    and each (row, column) term is formed once. "fields": each lane's
    16-byte loads start on 16 bytes and tile each run of K values exactly."""
    for name, v in _views(b, k, dtype).items():
        es = v.element_size()
        base = 7 * ALLOC  # a block start of the allocator
        addr = base + v.storage_offset() * es
        alloc_end = base + -(-v.untyped_storage().nbytes() // ALLOC) * ALLOC
        f = v.shape[1]
        plan = _plan(v, addr)
        assert plan.mode == _expected_mode(v), (name, plan)
        sb, sf = plan.stride_b * es, plan.stride_f * es
        assert plan.stride_f == (k if f == 1 else v.stride(1))
        if plan.mode == "fields":
            vec = 16 // es
            g = plan.group
            assert g & (g - 1) == 0 and 32 // vec <= g <= 32 and g * vec >= k
            assert plan.blocks * (t_fm.FWD_DIRECT_THREADS // g) >= b
            assert t_fm.fm_bwd_windows(plan, b, f, k, es, addr) == []
            for r in sorted({0, b // 2, b - 1}):
                lanes = np.arange(g)[np.arange(g) * vec < k]
                ff, ii = np.meshgrid(np.arange(f), lanes, indexing="ij")
                at = addr + r * sb + ff * sf + ii * 16  # each lane's loads
                assert (at % 16 == 0).all() and (at + 16 <= alloc_end).all()
                read = (at[..., None] + np.arange(0, 16, es)).ravel()
                want = (addr + r * sb + np.arange(f)[:, None] * sf
                        + np.arange(k)[None, :] * es).ravel()
                np.testing.assert_array_equal(np.sort(read), np.sort(want))
            continue
        assert plan.mode in ("span", "rows")
        assert plan.smem_bytes <= t_fm.BWD_SMEM_MAX and plan.smem_bytes % 16 == 0
        assert plan.smem_bytes >= (t_fm.FWD_BARRIER_BYTES + plan.stage_bytes
                                   + 4 * plan.rows_per_tile * k)
        assert plan.stage_bytes <= t_fm.FWD_TILE_BYTES or plan.rows_per_tile == 1
        assert plan.n_tiles == math.ceil(b / plan.rows_per_tile)
        assert plan.blocks == min(plan.n_tiles, t_fm.FWD_BLOCKS_PER_SM * SMS)
        taken = np.concatenate([np.arange(j, plan.n_tiles, plan.blocks)
                                for j in range(plan.blocks)])
        np.testing.assert_array_equal(np.sort(taken), np.arange(plan.n_tiles))
        tiles = t_fm.fm_bwd_windows(plan, b, f, k, es, addr)
        assert len(tiles) == plan.n_tiles
        row_bytes = (f - 1) * sf + k * es
        covered = np.zeros(b, np.int64)
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
            first = addr + b0 * sb
            if plan.mode == "span":
                (lo, n, _), = copies
                end = first + (rows - 1) * sb + row_bytes
                assert first - 15 <= lo <= first and end <= lo + n <= end + 15
            else:
                assert len(copies) == rows
                for r, (lo, n, _) in enumerate(copies):
                    assert first + r * sb - 15 <= lo <= first + r * sb
                    assert lo + n - 15 <= first + r * sb + row_bytes <= lo + n
            if t not in replay:
                continue
            np.testing.assert_array_equal(_phase1_writes(rows, k), 1)
            r, ff, kk = np.meshgrid(np.arange(rows), np.arange(f), np.arange(k), indexing="ij")
            if plan.mode == "span":
                row_at = first % 16 + r * sb
            else:
                row_at = r * plan.slot_bytes + (first + r * sb) % 16
            off = (row_at + ff * sf + kk * es).ravel()  # where the kernel reads
            starts = np.array([at for _, _, at in copies])
            which = np.searchsorted(starts, off, side="right") - 1
            lo_, n_, at_ = (np.array(c)[which] for c in zip(*copies))
            assert (off + es <= at_ + n_).all()
            src = lo_ + off - at_
            np.testing.assert_array_equal(
                src, (addr + (b0 + r) * sb + ff * sf + kk * es).ravel())
            assert len(np.unique(src)) == src.size
        np.testing.assert_array_equal(covered, 1)


def test_fm_fwd_plan_fills_the_card_at_every_batch_of_the_path():
    """The grid holds a block for each of the 132 SMs at B=512 and at
    B=8192, FWD_BLOCKS_PER_SM of them where the batch allows, a tile within
    FWD_TILE_BYTES; the fast step's view reads vectors, a row to 16 (fp32)
    or 8 (bf16) lanes."""
    shapes = [(512, 26 * 65, 65, 2), (512, 26 * 65, 65, 4), (4096, 26 * 65, 65, 2),
              (4096, 26 * 65, 65, 4), (8192, 26 * 65, 65, 2)]
    for b, sb, sf, es in shapes:
        plan = t_fm.fm_fwd_plan(b, 26, 64, sb, sf, es, True, SMS)
        assert plan.mode == "span" and plan.blocks >= SMS, (b, plan)
        assert plan.blocks == min(b, t_fm.FWD_BLOCKS_PER_SM * SMS), (b, plan)
        assert plan.stage_bytes <= t_fm.FWD_TILE_BYTES
    for es, lanes in ((4, 16), (2, 8)):
        plan = t_fm.fm_fwd_plan(8192, 26, 64, 26 * 128, 128, es, True, SMS)
        assert (plan.mode, plan.group) == ("fields", lanes)
        assert plan.blocks == 8192 * lanes // t_fm.FWD_DIRECT_THREADS >= SMS


def test_fm_fwd_plan_direct_mode():
    """A row wider than any stage, no fields or no columns: nothing staged,
    `group` lanes a row; the grid covers every row once. A start off 16
    bytes takes no vectors, whatever the strides."""
    for b, f, k in ((5, 26, 3000), (9, 0, 64), (9, 26, 0), (9, 26, 4)):
        plan = t_fm.fm_fwd_plan(b, f, k, f * k + 1 if k == 4 else f * k, k, 4, True, SMS)
        if k == 4:  # rows 4 * (26 * 4 + 1) bytes apart: neither a span nor aligned
            assert plan.mode == "rows"
            continue
        assert plan.mode == "direct" and plan.smem_bytes == 0
        g = plan.group
        rows_per_block = t_fm.FWD_DIRECT_THREADS // g
        rows = np.arange(plan.blocks * rows_per_block)
        np.testing.assert_array_equal(np.bincount(rows[rows < b], minlength=b), 1)
        assert t_fm.fm_bwd_windows(plan, b, f, k, 4, 0) == []
    assert t_fm.fm_fwd_plan(64, 26, 64, 26 * 128, 128, 4, False, SMS).mode == "span"


def test_fm_ctypes_signatures_match_the_c_entries():
    """The wrappers hand each C entry of fm.cu as many arguments as it
    declares (ctypes would refuse the call on the card only)."""
    text = (Path(t_fm.__file__).resolve().parent.parent / "kernels" / "csrc" / "fm.cu"
            ).read_text()
    for fn, (argtypes, _) in t_fm._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(argtypes) == len(m.group(1).split(",")), fn
    # the plan's mode names are fm.cu's FwdMode values, in order
    m = re.search(r"enum FwdMode : int \{([^}]*)\}", text)
    names = [re.sub(r"\s*=.*", "", e).strip() for e in m.group(1).split(",")]
    assert [n.removeprefix("kFwd").lower() for n in names] == list(t_fm.FWD_MODES)


def _kernel_replay(v: np.ndarray) -> np.ndarray:
    """The kernel's sums written out lane by lane in numpy fp32: each (b, k)
    term (S*S - Q, fields in order); lane j of 32 adds the terms k = j,
    j+32, ... in order from 0; five rounds of xor shuffles, every lane
    adding its partner's value; 0.5 times lane 0's sum. fp32 in, fp32 out."""
    b, f, k = v.shape
    s = np.zeros((b, k), np.float32)
    q = np.zeros((b, k), np.float32)
    for i in range(f):
        x = v[:, i, :]
        s = s + x
        q = q + x * x
    terms = s * s - q
    lanes = np.zeros((b, 32), np.float32)
    for kk in range(k):
        lanes[:, kk % 32] = lanes[:, kk % 32] + terms[:, kk]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    return np.float32(0.5) * lanes[:, 0]


def _terms(v: np.ndarray) -> np.ndarray:
    """Each (b, k) term S*S - Q, fields in order, in numpy fp32."""
    s = np.zeros((v.shape[0], v.shape[2]), np.float32)
    q = np.zeros_like(s)
    for i in range(v.shape[1]):
        s = s + v[:, i, :]
        q = q + v[:, i, :] * v[:, i, :]
    return s * s - q


def _vec_replay(v: np.ndarray, vec: int, group: int) -> np.ndarray:
    """fm_fwd_vec_kernel lane by lane: lane i of a row's `group` holds the
    terms of vector i (columns vec*i ... vec*i + vec - 1, zero past K); lane
    c adds those of lanes c, c + 32/vec, ... in order from 0; xor shuffles
    over lanes c ^ (off / vec) for off = 16 ... vec, then adds of elements e
    and e ^ off within a lane for off = vec/2 ... 1; 0.5 times lane 0's
    element 0."""
    b, _, k = v.shape
    c_lanes = 32 // vec
    d = np.zeros((b, group * vec), np.float32)
    d[:, :k] = _terms(v)
    d = d.reshape(b, group, vec)
    p = np.zeros((b, group, vec), np.float32) + d
    for m in range(c_lanes, group, c_lanes):
        p = p + d[:, (np.arange(group) + m) % group]
    off = 16
    while off >= vec:
        p = p + p[:, np.arange(group) ^ (off // vec)]
        off //= 2
    off = vec // 2
    while off > 0:
        p = p + p[:, :, np.arange(vec) ^ off]
        off //= 2
    return np.float32(0.5) * p[:, 0, 0]


def _direct_replay(v: np.ndarray, group: int) -> np.ndarray:
    """fm_fwd_direct_kernel lane by lane: lane j of a row's `group` adds the
    terms k = j, j + group, ... in order from 0; xor shuffles over group/2
    ... 1 lanes; 0.5 times lane 0's sum."""
    b, _, k = v.shape
    t = _terms(v)
    p = np.zeros((b, group), np.float32)
    for kk in range(k):
        p[:, kk % group] = p[:, kk % group] + t[:, kk]
    off = group // 2
    while off > 0:
        p = p + p[:, np.arange(group) ^ off]
        off //= 2
    return np.float32(0.5) * p[:, 0]


@pytest.mark.parametrize("dtype,k", [(torch.float32, 4), (torch.float32, 64),
                                     (torch.float32, 100), (torch.float32, 128),
                                     (torch.bfloat16, 8), (torch.bfloat16, 64),
                                     (torch.bfloat16, 256)])
def test_vector_and_direct_kernels_keep_the_staged_order(dtype, k):
    """The vector kernel's lanes (at the plan's group for an aligned view of
    2K columns) and the direct kernel's (at its group) give fm_fwd_in_order's
    bits: one order of sums in every mode."""
    rng = np.random.default_rng(k)
    v = to_tensor(rng.normal(0.0, 0.5, (9, 26, 2 * k)).astype(np.float32)).to(dtype)[..., :k]
    want = t_fm.fm_fwd_in_order(v, torch.float32).numpy().view(np.int32)
    plan = t_fm.fm_fwd_plan(9, 26, k, v.stride(0), v.stride(1), v.element_size(), True, SMS)
    assert plan.mode == "fields"
    v32 = v.float().numpy()
    np.testing.assert_array_equal(_vec_replay(v32, 16 // v.element_size(), plan.group)
                                  .view(np.int32), want)
    np.testing.assert_array_equal(_direct_replay(v32, t_fm._lanes_per_row(k)).view(np.int32),
                                  want)


def _fm_tolerance(v: np.ndarray, want: np.ndarray, bf16_out: bool) -> np.ndarray:
    """As chip_smoke.fm_tolerance: 1e-5 of 0.5*sum_k(S^2 + Q) (fp32 sums in
    another order), plus one bf16 ulp of the value for a bf16 output."""
    v64 = v.astype(np.float64)
    tol = FM_RTOL_OF_SCALE * 0.5 * ((v64.sum(1) ** 2) + (v64 ** 2).sum(1)).sum(-1)
    return tol + (BF16_ULP * np.abs(want.astype(np.float64)) if bf16_out else 0.0)


@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, None),
                                             (torch.bfloat16, None),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b,f,k", [(37, 26, 64), (7, 28, 4), (5, 26, 100), (3, 1, 64),
                                   (1, 26, 33)])
def test_fm_fwd_in_order_is_the_kernels_order_and_matches_plain(b, f, k, dtype, out_dtype):
    """fm_fwd_in_order gives the bits of the kernel's lane-by-lane order
    (replayed in numpy), on the model's strided view, and agrees with
    fm_cross_xla within the stated tolerance."""
    rng = np.random.default_rng(b * 1000 + f * 10 + k)
    fused = to_tensor(rng.normal(0.0, 0.3, (b, f, k + 1)).astype(np.float32)).to(dtype)
    v = fused[..., :k]
    got = t_fm.fm_fwd_in_order(v, out_dtype)
    want_dtype = out_dtype or dtype
    assert got.shape == (b,) and got.dtype == want_dtype
    replay = to_tensor(_kernel_replay(v.float().numpy())).to(want_dtype)
    view = torch.int32 if want_dtype == torch.float32 else torch.int16
    np.testing.assert_array_equal(got.view(view).numpy(), replay.view(view).numpy())
    plain = t_fm.fm_cross_xla(v, out_dtype)
    tol = _fm_tolerance(v.float().numpy(), plain.float().numpy(),
                        want_dtype == torch.bfloat16)
    assert np.all(np.abs(got.double().numpy() - plain.double().numpy()) <= tol)


@pytest.mark.parametrize("dtype,out", [("float32", "own"), ("bfloat16", "own"),
                                       ("bfloat16", "float32")])
@pytest.mark.parametrize("layout", ["strided", "concatenated"])
def test_fm_forward_matches_pallas_at_a_ragged_batch(layout, dtype, out):
    """fm_cross_xla == rectpu's fm_cross_pallas (its _fm_fwd_kernel in
    interpret mode) at B=37, a multiple of no tile, on the model's strided
    view and on the concatenated [B, F+2, K] of numeric fields. The fp32
    output of a bf16 v is the Pallas kernel's function on v's exact fp32
    values (the flat layout's unrounded logit). Tolerance as chip_smoke's
    fm_tolerance: 1e-5 of 0.5*sum_k(S^2 + Q), plus one bf16 ulp of a bf16
    output. fm_fwd_in_order stays within the same tolerance."""
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
    out_dtype = torch.float32 if out == "float32" else None
    pallas_in = jnp.asarray(v, jnp.float32) if out == "float32" else jnp.asarray(v)
    want = np.asarray(fm_cross_pallas(pallas_in, interpret=True), np.float32)
    bf16_out = dtype == "bfloat16" and out == "own"
    tol = _fm_tolerance(np.asarray(v, np.float32), want, bf16_out)
    for got in (t_fm.fm_cross_xla(t_v, out_dtype), t_fm.fm_fwd_in_order(t_v, out_dtype)):
        assert got.shape == (b,)
        assert got.dtype == (torch.bfloat16 if bf16_out else torch.float32)
        assert np.all(np.abs(got.double().numpy() - want.astype(np.float64)) <= tol)
