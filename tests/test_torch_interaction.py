"""Op-level checks of the port's DLRM pair-dot interaction against rectpu.

The plain version ``interact_plain`` (what the port runs on CPU tensors, and
the spec ``chip_smoke.py`` holds the CUDA kernel to on the card) is compared
with rectpu's Pallas ``interact_pallas`` in interpret mode, both variants, on
the same inputs made with numpy from a seed; the backward with ``jax.vjp`` of
rectpu's ``interact_flat(impl="xla")``.

Tolerances. The forward's sums are fp32 over K products taken in another
order: |got - want| <= 2*K*2^-24 * sum_k |a_k b_k|. The bf16 backward rounds
an fp32 sum to bf16 on both sides, so it may land one bf16 ulp (<= 2^-7 of the
value) apart, beyond the same sum-order bound.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.ops.interaction import interact_flat as jax_interact_flat
from rectpu.ops.interaction import interact_pallas
from rectpu_torch.ops import interaction as t_int

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
K = 8
BF16_REL_ULP = 2.0 ** -7


def _inputs(b, n, dtype, seed):
    """The same values in both packages: (jax array, torch tensor)."""
    jnp_dt, t_dt = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(0.0, 1.0, (b, n * K)).astype(np.float32)
    xj = jnp.asarray(x, jnp_dt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(t_dt)
    return xj, xt


def _sum_tol(xt, n, itself):
    v = xt.double().reshape(xt.shape[0], n, K)
    iu, ju = t_int.pairs(n, itself)
    return (2 * K * 2.0 ** -24 * (v[:, iu].abs() * v[:, ju].abs()).sum(-1)).numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("itself", [False, True])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5, 6])  # F fields, and F + 1 with a numeric vector appended
def test_plain_matches_interact_pallas(n, dtype, variant, itself):
    """B=19 is ragged against the Pallas 32-row blocks. "vpu" takes exact
    products, "mxu" rounds each product to the input dtype: in bf16 the
    rounded plain version matches and the exact one does not. One exception,
    of the interpret mode and not of the kernel: XLA's CPU compiler folds a
    group with a single pair (one all-ones selector column) into a
    reduction and drops the product's bf16 round trip, so those columns
    carry exact products."""
    xj, xt = _inputs(19, n, dtype, seed=n * 10 + len(dtype))
    ref = np.asarray(interact_pallas(xj, n, K, itself, 32, True, variant))
    assert ref.shape == (19, t_int.num_pairs(n, itself))
    tol = _sum_tol(xt, n, itself)
    exact = t_int.interact_plain(xt, n, K, itself, round_products=False).numpy()
    rounded = t_int.interact_plain(xt, n, K, itself, round_products=True).numpy()
    assert exact.dtype == rounded.dtype == np.float32
    if dtype == "float32":  # a product of fp32 values is rounded to fp32 either way
        np.testing.assert_array_less(np.abs(exact - ref), tol + 1e-30)
        np.testing.assert_array_less(np.abs(rounded - ref), tol + 1e-30)
        return
    if variant == "vpu":
        np.testing.assert_array_less(np.abs(exact - ref), tol + 1e-30)
        assert (np.abs(rounded - ref) > 10 * tol).any()
        return
    iu, _ = t_int.pairs(n, itself)
    single = np.bincount(iu)[iu] == 1
    np.testing.assert_array_less(np.abs(rounded - ref)[:, ~single], tol[:, ~single] + 1e-30)
    np.testing.assert_array_less(np.abs(exact - ref)[:, single], tol[:, single] + 1e-30)
    # the rounding shows: exact products miss the reference beyond the bound
    assert (np.abs(exact - ref)[:, ~single] > 10 * tol[:, ~single]).any()


@pytest.mark.parametrize("itself", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_rectpu_vjp(dtype, itself):
    """dflat of every impl (all run the same custom backward) equals jax.vjp
    of rectpu's interact_flat(impl="xla") (the gather-C batched-matmul
    backward), and the exact-product impls' forward equals rectpu's "xla"
    forward."""
    n = 6
    xj, xt = _inputs(11, n, dtype, seed=3 + itself)
    p = t_int.num_pairs(n, itself)
    g = np.random.default_rng(9).normal(0.0, 1.0, (11, p)).astype(np.float32)
    v = xt.double().reshape(11, n, K)
    mag = np.abs(g).sum(1)[:, None, None] * v.abs().amax(1, keepdim=True).numpy()
    bound = 2 * n * 2.0 ** -24 * mag.repeat(n, 1).reshape(11, n * K)
    out_j, vjp = jax.vjp(lambda f: jax_interact_flat(f, n, K, itself, impl="xla"), xj)
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want.astype(jnp.float32))
    tol = bound + (BF16_REL_ULP * np.abs(want) if dtype == "bfloat16" else 0.0)
    for impl in t_int.IMPLS:
        leaf = xt.clone().requires_grad_()
        out = t_int.interact_flat(leaf, n, K, itself, impl=impl)
        assert out.shape == (11, p) and out.dtype == torch.float32
        out.backward(torch.from_numpy(g))
        assert leaf.grad.dtype == xt.dtype
        np.testing.assert_array_less(np.abs(leaf.grad.float().numpy() - want), tol + 1e-30,
                                     err_msg=impl)
        if impl in ("pallas", "xla", "xla-autodiff"):
            np.testing.assert_array_less(np.abs(out.detach().numpy() - np.asarray(out_j)),
                                         _sum_tol(xt, n, itself) + 1e-30, err_msg=impl)


def test_impls_pick_the_kernel_flags_on_cpu():
    """"auto" and "pallas-mxu" run the rounded-product plain version,
    "pallas", "xla", "xla-autodiff" and the 3D form the exact one; unknown
    names raise; the kernel wrapper refuses a CPU tensor."""
    n = 5
    _, xt = _inputs(4, n, "bfloat16", seed=1)
    rounded = t_int.interact_plain(xt, n, K, round_products=True)
    exact = t_int.interact_plain(xt, n, K, round_products=False)
    assert not torch.equal(rounded, exact)
    for impl, want in (("auto", rounded), ("pallas-mxu", rounded), ("pallas", exact),
                       ("xla", exact), ("xla-autodiff", exact)):
        assert torch.equal(t_int.interact_flat(xt, n, K, impl=impl), want), impl
    assert torch.equal(t_int.interact(xt.reshape(4, n, K)), exact)
    with pytest.raises(ValueError, match="interaction_impl"):
        t_int.interact_flat(xt, n, K, impl="mxu")
    with pytest.raises(ValueError, match="CUDA"):
        t_int.interact_cuda(xt, n, K)
    assert t_int.launches.value == 0


# --- the kernel's launch plan (kernels/csrc/interaction.cu), held on the CPU ---


def _unit_tiles(n, itself, path):
    """The tiles the kernel walks on ``path``: each unit's run of tiles from
    its origin."""
    _, tj, _ = t_int.UNIT[path]
    return [(i0, j0 + t * tj) for i0, j0, tiles in t_int.units(n, itself, path)
            for t in range(tiles)]


def _pair_column(i, j, n, itself):
    """interaction.cu's closed form: entry (i, j) of the dot matrix goes to
    column row_base(i) + j when in_triangle(i, j), else nowhere (-1)."""
    skip = 0 if itself else 1
    if j - i >= skip and j < n:
        return i * (n - skip) - i * (i - 1) // 2 + j - i - skip
    return -1


@pytest.mark.parametrize("itself", [False, True])
def test_pair_column_sends_each_pair_once_in_order(itself):
    """For n in 1..40 the kernel's closed form gives every np.triu_indices
    pair its column, and -1 to every other entry of the 16-padded matrix
    (below the diagonal, past n), so each column is written once."""
    for n in range(1, 41):
        n_pad = -(-n // 16) * 16
        iu, ju = t_int.pairs(n, itself)
        got = [_pair_column(i, j, n, itself) for i, j in zip(iu, ju)]
        assert got == list(range(len(iu)))
        others = {(i, j) for i in range(n_pad) for j in range(n_pad)} - set(zip(iu, ju))
        assert all(_pair_column(i, j, n, itself) == -1 for i, j in others)


@pytest.mark.parametrize("path", ["gram", "ones", "tile"])
@pytest.mark.parametrize("itself", [False, True])
def test_units_cover_every_pair_once_and_skip_empty_tiles(itself, path):
    """For n in 1..40 the tiles that the units of the gram (16 x 8, runs of
    4), ones (4 x 4, runs of 4) and tile (4 x 4) paths walk lie inside the
    16-padded matrix, do not overlap, hold every pair, and each unit's first
    tile holds one (the tiles below the diagonal are skipped: at n=26 the
    gram path walks 6 of 8 tiles in 2 units)."""
    ti, tj, per = t_int.UNIT[path]
    for n in range(1, 41):
        n_pad = -(-n // 16) * 16
        walked = _unit_tiles(n, itself, path)
        assert len(walked) == len(set(walked))
        assert all(i0 % ti == 0 and j0 % tj == 0 and i0 + ti <= n_pad and j0 + tj <= n_pad
                   for i0, j0 in walked)
        held = {(i, j) for i0, j0 in walked for i in range(i0, i0 + ti)
                for j in range(j0, j0 + tj)}
        pairs = set(zip(*t_int.pairs(n, itself)))
        assert pairs <= held
        for i0, j0, tiles in t_int.units(n, itself, path):
            assert 1 <= tiles <= per and j0 + tj * tiles <= n_pad
            assert any((i, j) in pairs for i in range(i0, i0 + ti)
                       for j in range(j0, j0 + tj)), (n, i0, j0)
    if path == "gram":
        assert t_int.units(26, False, path) == [(0, 0, 4), (16, 16, 2)]
        assert len(_unit_tiles(26, False, path)) == 6


def _emulate(xt, n, k, itself, rounded):
    """The kernel's walk in plain PyTorch: the rows staged as [n_pad, k_pad]
    zero-padded tiles, each unit's tiles of the dot matrix computed (the
    products rounded to the input's type in rounded mode) and written to
    their columns by the closed form, each output once."""
    pl = t_int.plan(n, k, itself, xt.dtype, rounded)
    ti, tj, _ = t_int.UNIT[pl.path]
    b = xt.shape[0]
    v = torch.zeros(b, pl.n_pad, pl.k_pad, dtype=xt.dtype)
    v[:, :n, :k] = xt.reshape(b, n, k)
    out = torch.full((b, t_int.num_pairs(n, itself)), float("nan"))
    for i0, j0 in _unit_tiles(n, itself, pl.path):
        a, c = v[:, i0:i0 + ti].float(), v[:, j0:j0 + tj].float()
        prod = a[:, :, None, :] * c[:, None, :, :]
        if rounded:
            prod = prod.to(xt.dtype).float()
        tile = prod.sum(-1)
        for x in range(ti):
            for y in range(tj):
                p = _pair_column(i0 + x, j0 + y, n, itself)
                if p >= 0:
                    assert torch.isnan(out[:, p]).all()
                    out[:, p] = tile[:, x, y]
    return out


@pytest.mark.parametrize("rounded", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 17, 27, 33])
def test_emulated_tiling_matches_plain(n, dtype, rounded):
    """A plain emulation of the path the plan picks (gram: bf16 exact, ones:
    bf16 rounded, tile: fp32) fills every output once and agrees with
    interact_plain within the fp32 sum bound, at n on and off the 16-row
    tiles and with the diagonal both ways."""
    for itself in (False, True):
        if t_int.num_pairs(n, itself) == 0:
            continue
        _, xt = _inputs(7, n, dtype, seed=n + 2 * rounded)
        got = _emulate(xt, n, K, itself, rounded)
        assert not torch.isnan(got).any()
        want = t_int.interact_plain(xt, n, K, itself, round_products=rounded)
        np.testing.assert_array_less(np.abs(got.numpy() - want.numpy()),
                                     _sum_tol(xt, n, itself) + 1e-30)


def test_plan_paths_geometry_and_limit():
    """The plan picks the path by dtype and rounding; its staged tile keeps
    16-byte alignment, vectors 16 modulo 32 bytes apart (conflict-free
    ldmatrix; 64 modulo 128 on the ones path) and batch rows 16 modulo 128
    bytes apart; a group takes at most
    8 rows and its shared memory holds two buffers and the outputs. Every
    DLRM width the port trains or serves fits (n = 26 or 27 at K = 64, the
    CLI's default K = 4); past one block's 227 KB the wrapper raises."""
    for dtype, rounded, path in ((torch.bfloat16, False, "gram"), (torch.bfloat16, True, "ones"),
                                 (torch.float32, False, "tile"), (torch.float32, True, "tile")):
        es = 2 if dtype == torch.bfloat16 else 4
        for n, k in ((26, 64), (27, 64), (27, 4), (1, 8), (40, 24)):
            for itself in (False, True):
                pl = t_int.plan(n, k, itself, dtype, rounded)
                assert pl.path == path
                assert pl.n_pad % 16 == 0 and pl.n_pad >= n and pl.k_pad % 16 == 0
                assert (pl.ld * es) % (128 if path == "ones" else 32) == (64 if path == "ones"
                                                                          else 16)
                assert (pl.rs * es) % 128 == 16
                assert pl.rs >= pl.n_pad * pl.ld and 1 <= pl.rows <= 8
                p = t_int.num_pairs(n, itself)
                assert pl.smem == pl.rows * (2 * pl.rs * es + 4 * p) <= 227 * 1024
    assert t_int.plan(26, 64, False, torch.bfloat16, True).rows == 8
    assert t_int.plan(272, 64, True, torch.bfloat16, False).rows == 1
    with pytest.raises(ValueError, match="232448-byte limit"):
        t_int.plan(273, 64, True, torch.bfloat16, False)
    with pytest.raises(ValueError, match="shared memory"):
        t_int.plan(226, 64, True, torch.float32, True)


def c_arity(source: str, fn: str) -> int:
    """The number of parameters of ``extern "C" int fn(...)`` in a kernel
    source of rectpu_torch/kernels/csrc."""
    text = (Path(t_int.__file__).resolve().parent.parent / "kernels" / "csrc"
            / source).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, fn
    return len(m.group(1).split(","))


def test_ctypes_signature_matches_the_c_entry():
    """The wrapper hands the kernel's C entry as many arguments as it
    declares (ctypes would refuse the call on the card only)."""
    for fn, (argtypes, _) in t_int._SIGNATURES.items():
        assert len(argtypes) == c_arity("interaction.cu", fn), fn
