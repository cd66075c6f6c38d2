"""Op-level checks of the port's training ops against rectpu's own kernels.

Each plain PyTorch version in ``rectpu_torch.ops`` (the function its CUDA
kernel computes, and what the port runs on CPU tensors) is held against the
rectpu Pallas kernel it replaces, run in interpret mode on the CPU, on the
same inputs made with numpy from a seed: the dense scatter, the lookup's
backward, the FM backward, the fused Adam sweep. The counter-hash bits
(stochastic rounding, hash dropout) are held bit for bit. The CUDA kernels
themselves run only on the card: ``chip_smoke.py`` holds them against these
plain versions there.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.models.base import hash_dropout_mask as jax_dropout_mask
from rectpu.ops.embedding import lookup_flat, lookup_pallas
from rectpu.ops.fm import fm_cross_flat, fm_cross_pallas
from rectpu.ops.fused_adam import fused_adam_table as jax_fused_adam
from rectpu.ops.scatter_rows import DROP_SENTINEL, scatter_rows_dense
from rectpu.train.optimizers import BF16_SR as JAX_BF16_SR
from rectpu.train.optimizers import adam as jax_adam
from rectpu.train.optimizers import stochastic_round_bf16 as jax_sr
from rectpu_torch.models.base import hash_dropout_mask
from rectpu_torch.ops import embedding as t_emb
from rectpu_torch.ops import fm as t_fm
from rectpu_torch.ops import fused_adam as t_adam
from rectpu_torch.ops import scatter_rows as t_scatter
from rectpu_torch.train import optimizers as t_opt
from rectpu_torch.train.checkpoint import to_tensor

U32 = 2.0 ** -24  # fp32 unit roundoff
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype.itemsize == 4 else np.int16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _sum_tolerance(ids, upd, v_rows, out_bf16, value):
    """Per-element bound on |port - rectpu| of a dense scatter: both sum in
    fp32, in other orders, so a row of n updates may differ by up to
    2 n u sum|u| (u = 2^-24); a row with one update (no collision) is exact.
    A bf16 output adds one bf16 ulp of the value (the two fp32 sums may round
    to neighbouring bf16 values)."""
    ids = np.asarray(ids, np.int64)
    keep = (ids >= 0) & (ids < v_rows)
    mag = np.zeros((v_rows, upd.shape[1]))
    np.add.at(mag, ids[keep], np.abs(upd[keep].astype(np.float64)))
    count = np.bincount(ids[keep], minlength=v_rows)[:, None]
    tol = np.where(count > 1, 2.0 * count * U32 * mag, 0.0)
    if out_bf16:
        tol = tol + np.where(count > 1, BF16_ULP * np.abs(value), 0.0)
    return tol


# --- scatter -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_plain_matches_scatter_rows_dense(dtype):
    """Collisions (40 ids over 300 updates), rows no id touches, and
    DROP_SENTINEL / ids past the table, which add nothing."""
    rng = np.random.default_rng(0)
    v_rows, w, r = 256, 65, 300
    ids = np.concatenate([rng.integers(0, 40, r - 60), rng.integers(40, v_rows, 54),
                          [DROP_SENTINEL] * 3, [v_rows, v_rows + 5, 10**6]]).astype(np.int32)
    rng.shuffle(ids)
    upd = rng.normal(size=(r, w)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    upd_j = jnp.asarray(upd, jdt)
    want = scatter_rows_dense(jnp.asarray(ids), upd_j, v_rows, tile_rows=64, capacity=320,
                              out_dtype=jdt, interpret=True)
    upd_t = to_tensor(np.asarray(upd_j))
    got = t_scatter.scatter_rows_plain(torch.from_numpy(ids), upd_t, v_rows)
    assert got.dtype == upd_t.dtype and got.shape == (v_rows, w)
    want_f = np.asarray(want, np.float32)
    tol = _sum_tolerance(ids, np.asarray(upd_j, np.float32), v_rows, dtype == "bfloat16",
                         want_f)
    assert np.all(np.abs(_np(got) - want_f) <= tol)
    untouched = np.bincount(ids[ids < v_rows], minlength=v_rows) == 0
    assert untouched.any() and not got[torch.from_numpy(untouched)].any()
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(t_scatter.scatter_rows_dense(torch.from_numpy(ids), upd_t, v_rows), got)


def _radix_sorted(ids: np.ndarray, v_rows: int, tile: int = t_scatter.RADIX_TILE):
    """The kernels' LSD radix sort in numpy: ids outside [0, v_rows) take the
    key v_rows; each of sort_passes(v_rows) 8-bit passes places a position at
    (keys with a smaller digit) + (its digit in earlier tiles of ``tile``
    positions: the look-back) + (its digit earlier in its tile: the warp ranks
    and the per-warp bases, all in position order). Returns (keys, positions)."""
    n = ids.shape[0]
    keys = np.where((ids >= 0) & (ids < v_rows), ids, v_rows).astype(np.int64)
    pos = np.arange(n)
    for p in range(t_scatter.sort_passes(v_rows)):
        digit = (keys >> (t_scatter.RADIX_BITS * p)) & 255
        hist = np.bincount(digit, minlength=256)
        below = np.cumsum(hist) - hist
        earlier_tiles = np.zeros(256, np.int64)
        dst = np.empty(n, np.int64)
        for t0 in range(0, n, tile):
            in_tile = np.zeros(256, np.int64)
            for i in range(t0, min(t0 + tile, n)):
                d = digit[i]
                dst[i] = below[d] + earlier_tiles[d] + in_tile[d]
                in_tile[d] += 1
            earlier_tiles += in_tile
        keys_out, pos_out = np.empty_like(keys), np.empty_like(pos)
        keys_out[dst], pos_out[dst] = keys, pos
        keys, pos = keys_out, pos_out
    return keys, pos


def _pieces_summed(keys, pos, upd: torch.Tensor, v_rows: int, chunk: int, out_dtype):
    """The kernels' sums of the sorted stream in plain PyTorch: pieces of
    ``chunk`` positions; each run of equal keys summed in fp32 in position
    order; a run inside a piece written at once, a run cut by a piece edge
    kept as the piece's first or last partial; then each cut run's partials
    added in piece order, from its first piece's. Keys outside [0, v_rows)
    add nothing."""
    n, w = upd.shape
    u, out = upd.float(), torch.zeros(v_rows, w)
    first, last = {}, {}
    for c in range(-(-n // chunk)):
        lo, hi = c * chunk, min(c * chunk + chunk, n)
        s = lo
        while s < hi:
            key, acc, e = keys[s], torch.zeros(w), s
            while e < hi and keys[e] == key:
                acc += u[pos[e]]
                e += 1
            if 0 <= key < v_rows:
                starts = s > lo or lo == 0 or keys[lo - 1] != key
                ends = e < hi or hi == n or keys[hi] != key
                if starts and ends:
                    out[key] = acc
                if not starts:
                    first[c] = acc
                if not ends:
                    last[c] = acc
            s = e
    for c, acc in last.items():
        key, lo = keys[c * chunk + chunk - 1], c * chunk
        if lo > 0 and keys[lo] == key and keys[lo - 1] == key:
            continue  # a middle piece: the run started before it
        total, p = acc.clone(), c + 1
        while True:
            total += first[p]
            end = (p + 1) * chunk
            if end >= n or keys[end] != key:
                break
            p += 1
        out[key] = total
    return out.to(out_dtype)


def _scatter_case(case: str, rng):
    """(ids [R] int32, width, v_rows) of the streams the kernels must order
    and cut: a hot row holding most positions (a 2-row field's, as ml-100k's
    genre flags), rows no id touches with DROP_SENTINEL and ids past either
    end, no update at all, and the reference default's narrow rows (K=4: the
    packed W=5, and W=4)."""
    if case == "hot":
        ids = np.where(rng.random(700) < 0.8, 3, rng.integers(0, 64, 700))
        return ids.astype(np.int32), 65, 64
    if case == "dropped":
        ids = np.concatenate([rng.integers(0, 40, 400), [DROP_SENTINEL] * 5,
                              [-1, 256, 10**6, -2**31, 2**31 - 1]])
        rng.shuffle(ids)
        return ids.astype(np.int32), 65, 256
    if case == "empty":
        return np.zeros(0, np.int32), 65, 64
    width = 5 if case == "narrow5" else 4
    ids = np.stack([rng.integers(0, 2, 300), 2 + rng.integers(0, 2, 300),
                    4 + rng.integers(0, 50, 300)], axis=1).reshape(-1)
    return ids.astype(np.int32), width, 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["hot", "dropped", "empty", "narrow4", "narrow5"])
def test_emulated_scatter_order_and_pieces_match_rectpu(case, dtype):
    """The kernels' walk emulated (the radix sort with 64-position tiles, so
    several tiles run the look-back's prefix; pieces of 16 positions, so hot
    runs cross many pieces) equals the stable sort of the ids, and its sums
    match rectpu's scatter_rows_dense (interpret mode) and the plain version
    within _sum_tolerance; untouched rows are exactly zero."""
    rng = np.random.default_rng({"hot": 1, "dropped": 2, "empty": 3}.get(case, 4))
    ids, w, v_rows = _scatter_case(case, rng)
    keys, pos = _radix_sorted(ids, v_rows, tile=64)
    mapped = np.where((ids >= 0) & (ids < v_rows), ids, v_rows)
    np.testing.assert_array_equal(pos, np.argsort(mapped, kind="stable"))
    np.testing.assert_array_equal(keys, mapped[pos])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    upd_j = jnp.asarray(rng.normal(size=(ids.shape[0], w)).astype(np.float32), jdt)
    upd_t = to_tensor(np.asarray(upd_j))
    got = _pieces_summed(keys, pos, upd_t, v_rows, 16, upd_t.dtype)
    plain = t_scatter.scatter_rows_plain(torch.from_numpy(ids), upd_t, v_rows)
    upd_f = np.asarray(upd_j, np.float32)
    if ids.shape[0]:
        capacity = -(-ids.shape[0] // 8) * 8  # no tile overflows: rectpu's fp32 path
        # rectpu takes ids in [0, v_rows) or past the table: a negative id
        # sorts before its tile 0 and shifts the tiles' windows (ROADMAP C),
        # so its side gets DROP_SENTINEL, which it drops, in place of one
        jids = np.where(ids < 0, DROP_SENTINEL, ids).astype(np.int32)
        want = np.asarray(scatter_rows_dense(jnp.asarray(jids), upd_j, v_rows, tile_rows=64,
                                             capacity=capacity, out_dtype=jdt, interpret=True),
                          np.float32)
    else:
        want = np.zeros((v_rows, w), np.float32)
    tol = _sum_tolerance(ids, upd_f, v_rows, dtype == "bfloat16", want)
    assert got.dtype == upd_t.dtype and got.shape == (v_rows, w)
    assert np.all(np.abs(_np(got) - want) <= tol)
    assert np.all(np.abs(_np(got) - _np(plain)) <= tol)
    touched = np.bincount(ids[(ids >= 0) & (ids < v_rows)].astype(np.int64), minlength=v_rows)
    assert not got[torch.from_numpy(touched == 0)].any()


def test_sort_plan_depends_on_the_shapes_alone():
    """The wrapper's plan (passes of the radix sort, the state it zeroes, the
    pieces) is a function of R and v_rows: enough 8-bit passes for the
    sentinel key v_rows, 256 counts, a ticket and 256 look-back words a
    4,096-position tile a pass. The order it yields depends on the ids
    alone (the emulated sort is the stable argsort, whatever the tile)."""
    assert [t_scatter.sort_passes(v) for v in (1, 255, 256, 6144, 311_296, 2**31 - 2)] == \
        [1, 1, 2, 2, 3, 4]
    assert t_scatter.sort_state_words(106_496, 6144) == 2 * (1 + 256 * (1 + 26))
    assert t_scatter.sort_state_words(0, 6144) == 2 * (1 + 256)
    rng = np.random.default_rng(5)
    ids = rng.integers(-3, 300, 1000).astype(np.int32)
    ref = _radix_sorted(ids, 280, tile=1000)
    for tile in (7, 64, 333):
        got = _radix_sorted(ids, 280, tile=tile)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_scatter_ctypes_signatures_match_the_c_entries():
    """The wrappers hand each C entry of kernels/csrc/scatter_rows.cu as many
    arguments as it declares (ctypes would refuse the call on the card only)."""
    text = (Path(t_scatter.__file__).resolve().parent.parent / "kernels" / "csrc"
            / "scatter_rows.cu").read_text()
    for fn, (argtypes, _) in t_scatter._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m and len(argtypes) == len(m.group(1).split(",")), fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_backward_matches_lookup_pallas(dtype):
    """The port's lookup backward == jax.grad through lookup_pallas (the
    Pallas _bwd_kernel in interpret mode): fp32 sums of colliding ids,
    negative ids and ids past the table add nothing; a bf16 table gets its
    cotangent rounded once to bf16."""
    rng = np.random.default_rng(1)
    v, w = 300, 9
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    table = jnp.asarray(rng.normal(size=(v, w)).astype(np.float32), jdt)
    ids = rng.integers(0, 20, (16, 26)).astype(np.int32)  # heavy collisions
    ids[0, :4] = [-1, -9, v, v + 40]
    g = jnp.asarray(rng.normal(size=(16, 26, w)).astype(np.float32), jdt)
    want = jax.grad(lambda t: jnp.sum(
        lookup_pallas(t, jnp.asarray(ids), interpret=True).astype(jnp.float32)
        * g.astype(jnp.float32)))(table)
    t_table = to_tensor(np.asarray(table)).requires_grad_(True)
    out = t_emb.lookup(t_table, torch.from_numpy(ids))
    (out.float() * to_tensor(np.asarray(g)).float()).sum().backward()
    got = t_table.grad
    assert got.dtype == t_table.dtype
    want_f = np.asarray(want, np.float32)
    flat = ids.reshape(-1)
    tol = _sum_tolerance(flat, np.asarray(g, np.float32).reshape(-1, w), v,
                         dtype == "bfloat16", want_f)
    assert np.all(np.abs(_np(got) - want_f) <= tol)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_lookup_backward_matches_lookup_flat_mxu(compute):
    """The port's lookup backward, with the gather and grad dtypes of the
    flat layout, == jax.grad through rectpu's lookup_flat(scatter_impl="mxu")
    (small fields by multihot matmul, a dense-medium field by a one-hot
    matmul, a huge field through scatter_rows_dense in interpret mode), for
    both outputs: the flat embeddings and the summed linear logit."""
    rng = np.random.default_rng(2)
    sizes = (3, 2, 7, 50, 300)  # small, small, small, dense-medium, huge
    offsets = tuple(int(o) for o in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    k, b = 4, 32
    v = 384
    table = rng.normal(size=(v, k + 1)).astype(np.float32)
    ids = np.stack([o + rng.integers(0, s, b) for o, s in zip(offsets, sizes)],
                   axis=1).astype(np.int32)
    g_emb = rng.normal(size=(b, len(sizes) * k)).astype(np.float32)
    g_lin = rng.normal(size=(b,)).astype(np.float32)
    jdt = jnp.bfloat16 if compute else None

    def loss(t):
        emb, lin = lookup_flat(t, jnp.asarray(ids), (offsets, sizes), k, small_threshold=8,
                               gather_dtype=jdt, grad_dtype=jdt, scatter_impl="mxu",
                               dense_threshold=64)
        return jnp.sum(emb.astype(jnp.float32) * g_emb) + jnp.sum(lin * g_lin)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    tdt = torch.bfloat16 if compute else None
    t_table = torch.from_numpy(table).requires_grad_(True)
    looked = t_emb.lookup(t_table, torch.from_numpy(ids), gather_dtype=tdt, grad_dtype=tdt)
    emb = looked[..., :k].reshape(b, -1)
    lin = looked[..., k].float().sum(-1)
    ((emb.float() * torch.from_numpy(g_emb)).sum()
     + (lin * torch.from_numpy(g_lin)).sum()).backward()
    got = _np(t_table.grad)
    assert t_table.grad.dtype == torch.float32
    upd = np.concatenate([g_emb.reshape(b, len(sizes), k),
                          np.broadcast_to(g_lin[:, None, None], (b, len(sizes), 1))], axis=2)
    if compute:  # the cotangent reaches the scatter in bf16
        upd = np.asarray(jnp.asarray(upd, jnp.bfloat16), np.float32)
    tol = _sum_tolerance(ids.reshape(-1), upd.reshape(-1, k + 1), v, compute is not None, want)
    assert np.all(np.abs(got - want) <= tol)


# --- FM ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 64])
def test_fm_backward_matches_fm_cross_pallas(k, dtype):
    """dv = g*(S - v): the plain backward on the strided view == jax.grad
    through fm_cross_pallas (the Pallas _fm_bwd_kernel in interpret mode).
    Tolerance: S is an fp32 sum over fields in another order, so 1e-5 of
    |g| * sum_f |v|; in bf16, plus one bf16 ulp of the value."""
    rng = np.random.default_rng(k)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fused = np.asarray(jnp.asarray(rng.normal(0.0, 0.3, (16, 26, k + 1)).astype(np.float32),
                                   jdt))
    v = np.ascontiguousarray(fused[..., :k])
    g = jnp.asarray(rng.normal(size=(16,)).astype(np.float32), jdt)
    want = jax.grad(lambda x: jnp.sum(
        fm_cross_pallas(x, interpret=True).astype(jnp.float32) * g.astype(jnp.float32)))(
        jnp.asarray(v))
    t_v = to_tensor(fused)[..., :k].requires_grad_(False)
    assert not t_v.is_contiguous()
    t_v.requires_grad_(True)
    out = t_fm.fm_cross(t_v)
    assert out.dtype == t_v.dtype
    (out.float() * to_tensor(np.asarray(g)).float()).sum().backward()
    got = t_v.grad
    assert got.dtype == t_v.dtype
    want_f = np.asarray(want, np.float32)
    v64 = np.asarray(v, np.float64)
    scale = np.abs(np.asarray(g, np.float64))[:, None, None] * np.abs(v64).sum(1, keepdims=True)
    tol = 1e-5 * scale + (BF16_ULP * np.abs(want_f) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(_np(got) - want_f) <= tol)
    # the plain backward is the function autograd ran
    assert torch.equal(t_fm.fm_cross_bwd_xla(t_v.detach(), to_tensor(np.asarray(g))), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_fp32_out_matches_fm_cross_flat(dtype):
    """out_dtype=float32 is the flat layout's FM logit: fm_cross_flat on the
    same values laid out [B, F*K], not rounded to bf16. Tolerance 1e-5 of
    0.5 * sum_k(S^2 + Q), as for the forward (the FM cancels)."""
    rng = np.random.default_rng(5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    v = np.asarray(jnp.asarray(rng.normal(0.0, 0.3, (16, 26, 8)).astype(np.float32), jdt))
    want = np.asarray(fm_cross_flat(jnp.asarray(v.reshape(16, -1)), 26, 8))
    got = t_fm.fm_cross(to_tensor(v), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    v64 = np.asarray(v, np.float64)
    scale = 0.5 * ((v64.sum(1) ** 2) + (v64 ** 2).sum(1)).sum(-1)
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * scale)


# --- Adam and the counter-hash bits -----------------------------------------------

ADAM_CASES = [
    # (param dtype, m slot, v slot)
    ("float32", None, None),
    ("float32", "bfloat16", "sr"),
    ("float32", "bfloat16", "bfloat16"),
    ("float32", "sr", "sr"),
    ("bfloat16", "bfloat16", "sr"),
]
_J = {None: None, "float32": jnp.float32, "bfloat16": jnp.bfloat16, "sr": JAX_BF16_SR}
_T = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16, "sr": t_opt.BF16_SR}


def _store(dt):
    return jnp.bfloat16 if dt in ("bfloat16", "sr") else jnp.float32


def _adam_inputs(p_dtype, m_dt, v_dt, seed=0):
    rng = np.random.default_rng(seed)
    vr, w = 64, 5
    p = jnp.asarray(rng.normal(size=(vr, w)), jnp.float32).astype(_J[p_dtype])
    m = jnp.asarray(rng.normal(size=(vr, w)) * 0.1, jnp.float32).astype(_store(m_dt))
    v = jnp.asarray(rng.random((vr, w)) * 0.01, jnp.float32).astype(_store(v_dt))
    g = jnp.asarray(rng.normal(size=(vr, w)), jnp.float32).astype(jnp.bfloat16)
    return p, m, v, g


def _ulp(x, dtype) -> np.ndarray:
    """One unit in the last place of |x| in ``dtype`` (fp32 or bf16), as fp64."""
    x32 = np.abs(np.asarray(x, np.float32))
    spacing = np.spacing(x32).astype(np.float64)
    return spacing * (2.0 ** 16 if dtype == torch.bfloat16 else 1.0)


def _adam_close(want, got, slack) -> bool:
    """|want - got| <= 1 ulp of the output in its dtype + ``slack``."""
    a = np.asarray(want, np.float64)
    b = _np(got).astype(np.float64)
    return bool(np.all(np.abs(a - b) <= _ulp(want, got.dtype) + slack))


@pytest.mark.parametrize("p_dtype,m_dt,v_dt", ADAM_CASES)
def test_fused_adam_matches_rectpu(p_dtype, m_dt, v_dt):
    """The plain fused Adam == rectpu's fused_adam_table (interpret mode) and
    the port's tree-map Adam == rectpu's optimizers.adam, each output within
    1 ulp in its own dtype plus the last-place rounding of what it was
    computed from. XLA contracts b*m + (1-b)*g into an FMA where the port
    rounds twice (tests/test_fused_adam.py allows the same), so a slot may
    differ by 2^-23 of the terms it sums (many ulps of the result where the
    two terms cancel); a stochastic rounding may then land one bf16 ulp
    apart; and the parameter inherits the slots' difference through its
    step lr_t*m/(sqrt(v)+eps): 2^-22 of the step with fp32 slots, one bf16
    ulp (2^-7) of it with bf16 slots."""
    p, m, v, g = _adam_inputs(p_dtype, m_dt, v_dt)
    tp, tm, tv, tg = (to_tensor(np.asarray(x)) for x in (p, m, v, g))
    opt_j = jax_adam(learning_rate=1e-3, slot_dtype={"m": _J[m_dt], "v": _J[v_dt]})
    opt_t = t_opt.adam(learning_rate=1e-3, slot_dtype={"m": _T[m_dt], "v": _T[v_dt]})
    for t in (1, 7, 12345):
        want_fused = jax_fused_adam(p, m, v, g, jnp.asarray(t, jnp.int32), lr=1e-3,
                                    m_sr=m_dt == "sr", v_sr=v_dt == "sr", tile_rows=64,
                                    interpret=True)
        got_fused = t_adam.fused_adam_table(tp, tm, tv, tg, t, lr=1e-3, m_sr=m_dt == "sr",
                                            v_sr=v_dt == "sr")
        state_j = {"m": {"w": m}, "v": {"w": v}, "t": jnp.asarray(t - 1, jnp.int32)}
        new_p, new_s = opt_j.update({"w": g}, state_j, {"w": p})
        want_tree = (new_p["w"], new_s["m"]["w"], new_s["v"]["w"])
        params = {"w": tp.clone()}
        state_t = {"m": {"w": tm.clone()}, "v": {"w": tv.clone()},
                   "t": torch.tensor(t - 1, dtype=torch.int32)}
        opt_t.update({"w": tg}, state_t, params)
        got_tree = (params["w"], state_t["m"]["w"], state_t["v"]["w"])
        g64 = np.asarray(g, np.float64)
        m_terms = 0.9 * np.abs(np.asarray(m, np.float64)) + 0.1 * np.abs(g64)
        v_terms = 0.999 * np.abs(np.asarray(v, np.float64)) + 0.001 * g64 * g64
        rel = BF16_ULP if (m_dt is not None or v_dt is not None) else 2.0 ** -22
        for want, got in ((want_fused, got_fused), (want_tree, got_tree)):
            for name, a, b in zip("pmv", want, got):
                assert _bits(b).dtype == _bits(np.asarray(a)).dtype, name
            step = np.abs(np.asarray(p, np.float64) - np.asarray(want[0], np.float64))
            assert _adam_close(want[0], got[0], rel * step), f"p t={t}"
            assert _adam_close(want[1], got[1], 2.0 ** -23 * m_terms), f"m t={t}"
            assert _adam_close(want[2], got[2], 2.0 ** -23 * v_terms), f"v t={t}"
        assert int(state_t["t"]) == t
        # the plain fused sweep is the tree-map update, bit for bit
        for a, b in zip(got_fused, got_tree):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_fused_leaves_route_to_the_fused_sweep():
    """adam(fused_leaves=("table",)) runs the [V, W] leaf through
    ops.fused_adam (its plain version on the CPU) and the rest through the
    tree-map update, with the same results."""
    rng = np.random.default_rng(3)
    params = {"table": torch.from_numpy(rng.normal(size=(32, 5)).astype(np.float32)),
              "b": torch.zeros(())}
    grads = {k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
             for k, p in params.items()}
    slots = {"m": torch.bfloat16, "v": t_opt.BF16_SR}
    outs = []
    for fused in ((), ("table",)):
        opt = t_opt.adam(slot_dtype=slots, fused_leaves=fused)
        ps = {k: p.clone() for k, p in params.items()}
        st = opt.init(ps)
        calls = t_adam.launches.value
        for _ in range(3):
            opt.update(grads, st, ps)
        assert t_adam.launches.value == calls  # the CPU runs the plain version
        outs.append((ps, st))
    for k in params:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1]["v"][k], outs[1][1]["v"][k])


def test_get_optimizer_ports_adam_only():
    assert isinstance(t_opt.get_optimizer("Adam", 0.01), t_opt.Adam)
    for name in ("Adagrad", "Ftrl", "RMSProp", "SGD"):
        with pytest.raises(NotImplementedError, match="queue A5"):
            t_opt.get_optimizer(name)


@pytest.mark.parametrize("seed", [0, 7, 2**30 + 5, 2**32 - 1])
def test_stochastic_round_bf16_bitwise(seed):
    rng = np.random.default_rng(seed % 1000)
    x = (rng.normal(size=(37, 13)) * np.exp(rng.normal(size=(37, 13)) * 4)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, np.float32(3.0e38)]
    want = jax_sr(jnp.asarray(x), jnp.asarray(seed, jnp.uint32))
    got = t_opt.stochastic_round_bf16(torch.from_numpy(x), seed)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("shape", [(64, 256), (8, 33), (5, 3, 10), (7,)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_mask_bitwise(shape, rate):
    """Both layouts: the even-width half split and the odd-width finalizer."""
    for seed in (0, 12345, 0xFFFFFFFF):
        want = np.asarray(jax_dropout_mask(jnp.uint32(seed), shape, rate))
        got = hash_dropout_mask(seed, shape, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper launches its kernel or raises: handed CPU tensors it
    raises rather than running the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        t_scatter.scatter_rows_cuda(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 3), 8)
    with pytest.raises(ValueError, match="CUDA"):
        t_fm.fm_cross_bwd_cuda(torch.zeros(2, 3, 4), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        z = torch.zeros(4, 3)
        t_adam.fused_adam_cuda(z, z, z, z, 1, lr=1e-3)
