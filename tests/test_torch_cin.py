"""Op-level checks of the port's CIN core against rectpu.

The plain versions ``cin_plain`` and ``cin_dw_plain`` (what the port runs on
CPU tensors, and the spec ``chip_smoke.py`` holds the CUDA kernels to on the
card) are compared with rectpu's Pallas ``_cin_pallas`` (variants "flat" and
"mloop") and ``_cin_dw_pallas`` in interpret mode, on the same inputs made
with numpy from a seed; ``cin_core``'s gradients with ``jax.vjp`` of rectpu's
``cin_core``; the K-major forms with ``cin_core_kmajor``.

Tolerances. Both sides round each product x*y to x's dtype and sum in fp32 in
different orders: |got - want| <= 2*n*2^-24 * sum |terms| over the n summed
terms. A bf16 result is rounded from those fp32 sums, so it may also land one
bf16 ulp (<= 2^-7 of the value) apart.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.ops.cin import _cin_dw_pallas, _cin_pallas
from rectpu.ops.cin import cin_core as jax_cin_core
from rectpu.ops.cin import cin_core_kmajor as jax_cin_core_kmajor
from rectpu_torch.ops import cin as t_cin

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, H, M, O, K = 13, 3, 4, 2, 8  # B ragged against the 8-row Pallas tiles
BF16_REL_ULP = 2.0 ** -7


def _arrays(dtype, seed, *shapes, scale=1.0):
    """The same values in both packages: [(jax array, torch tensor), ...]."""
    jnp_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = jnp.asarray(rng.normal(0.0, scale, shape).astype(np.float32), jnp_dt)
        out.append((a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(t_dt)))
    return out


def _mag(x, y, w):
    """sum_{h,m} |w| |x y| per output [B, O, K], from [B, *, K] tensors."""
    z = (x.double()[:, :, None, :] * y.double()[:, None, :, :]).abs()
    return torch.einsum("bhmk,hmo->bok", z, w.double().abs()).numpy()


def _tol(mag, n, want, dtype):
    tol = 2 * n * 2.0 ** -24 * mag
    return tol + (BF16_REL_ULP * np.abs(want) if dtype == "bfloat16" else 0.0) + 1e-30


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) else t.float().numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on few cores; one intra-op thread keeps
    these small-shape tests from crowding the workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["flat", "mloop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_contraction_matches_cin_pallas(dtype, variant):
    """In interpret mode on the CPU, XLA fuses the "mloop" variant's bf16
    product a * c[:, m] into its fp32 dot and drops the product's bf16 round
    trip, so there that variant computes exact products: it is held against
    the plain version on the fp32 values of the same bf16 inputs (exact
    products), rounded to bf16. The "flat" variant rounds as the TPU does."""
    (xj, xt), (yj, yt), (wj, wt) = _arrays(dtype, 1, (B, H, K), (B, M, K), (H, M, O),
                                           scale=0.8)
    ref = _np(_cin_pallas(xj, yj, wj, interpret=True, tile_b=8, variant=variant))
    if dtype == "bfloat16" and variant == "mloop":
        got = t_cin.cin_plain(xt.float(), yt.float(), wt.float()).to(xt.dtype)
        assert not torch.equal(got, t_cin.cin_plain(xt, yt, wt))  # the rounding shows
    else:
        got = t_cin.cin_plain(xt, yt, wt)
    assert got.shape == (B, O, K) and got.dtype == xt.dtype
    np.testing.assert_array_less(np.abs(_np(got) - ref),
                                 _tol(_mag(xt, yt, wt), H * M, ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dw_matches_cin_dw_pallas(dtype):
    (xj, xt), (yj, yt), (gj, gt) = _arrays(dtype, 2, (B, H, K), (B, M, K), (B, O, K))
    ref = np.asarray(_cin_dw_pallas(xj, yj, gj, interpret=True, tile_b=8))
    got = t_cin.cin_dw_plain(xt, yt, gt)
    assert got.shape == (H, M, O) and got.dtype == torch.float32
    z = (xt.double()[:, :, None, :] * yt.double()[:, None, :, :]).abs()
    mag = torch.einsum("bhmk,bok->hmo", z, gt.double().abs()).numpy()
    np.testing.assert_array_less(np.abs(got.numpy() - ref), 2 * B * K * 2.0 ** -24 * mag + 1e-30)


def _check_vjp(dtype, layout, jax_fn, t_fn, shapes, seed):
    """Forward and all three gradients of ``t_fn`` against jax.vjp of
    ``jax_fn``; the magnitudes of the summed terms are the same functions of
    the operands' absolute values (fp64)."""
    (xj, xt), (yj, yt), (wj, wt), (gj, gt) = _arrays(dtype, seed, *shapes, scale=0.7)
    out_j, vjp = jax.vjp(jax_fn, xj, yj, wj)
    grads_j = vjp(gj)
    leaves = [t.clone().requires_grad_() for t in (xt, yt, wt)]
    out_t = t_fn(*leaves)
    out_t.backward(gt)
    got = [out_t.detach()] + [leaf.grad for leaf in leaves]
    want = [out_j, *grads_j]
    ax, ay, aw, ag = (t.double().abs() for t in (xt, yt, wt, gt))
    mags = [t_cin.cin_plain(ax, ay, aw, layout),
            t_cin.cin_plain(ag, ay, aw.permute(2, 1, 0), layout),
            t_cin.cin_plain(ag, ax, aw.permute(2, 0, 1), layout),
            t_cin.cin_dw_plain(ax, ay, ag, layout)]
    n = max(H * M, O * M, O * H, B * K)
    for name, a, b, mag in zip(("out", "dx", "dy", "dw"), got, want, mags):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == DTYPES[dtype][1], name
        a, b = _np(a), _np(b)
        np.testing.assert_array_less(np.abs(a - b), _tol(mag.numpy(), n, b, dtype),
                                     err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cin_core_vjp_matches_rectpu(dtype):
    _check_vjp(dtype, "legacy", lambda x, y, w: jax_cin_core(x, y, w, impl="xla"),
               lambda x, y, w: t_cin.cin_core(x, y, w),
               [(B, H, K), (B, M, K), (H, M, O), (B, O, K)], seed=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cin_core_kmajor_matches_rectpu(dtype):
    _check_vjp(dtype, "kmajor", jax_cin_core_kmajor, t_cin.cin_core_kmajor,
               [(B, K, H), (B, K, M), (H, M, O), (B, K, O)], seed=4)


def test_layouts_agree_and_the_wrappers_refuse_cpu_tensors():
    """The K-major plain versions are the legacy ones on transposed
    operands; cin_core runs the plain version on CPU tensors; the kernel
    wrappers raise on CPU tensors."""
    (_, xt), (_, yt), (_, wt), (_, gt) = _arrays("float32", 5, (B, H, K), (B, M, K),
                                                  (H, M, O), (B, O, K))
    legacy = t_cin.cin_plain(xt, yt, wt)
    km = t_cin.cin_plain(xt.transpose(1, 2), yt.transpose(1, 2), wt, layout="kmajor")
    assert torch.equal(km, legacy.transpose(1, 2))
    assert torch.equal(t_cin.cin_dw_plain(xt, yt, gt),
                       t_cin.cin_dw_plain(xt.transpose(1, 2), yt.transpose(1, 2),
                                          gt.transpose(1, 2), layout="kmajor"))
    assert torch.equal(t_cin.cin_core(xt, yt, wt), legacy)
    with pytest.raises(ValueError, match="CUDA"):
        t_cin.cin_cuda(xt, yt, wt)
    with pytest.raises(ValueError, match="CUDA"):
        t_cin.cin_dw_cuda(xt, yt, gt)
    assert t_cin.launches.value == 0 and t_cin.dw_launches.value == 0
    assert t_cin.launches_fp32.value == 0 and t_cin.dw_launches_fp32.value == 0
    assert t_cin.dw_slices(524_288) == (128, 4096) and t_cin.dw_slices(100) == (1, 128)


# --- the bf16 weight-gradient kernel's launch plan, held on the CPU -----------


def test_ctypes_signatures_match_the_c_entries():
    """The wrappers hand each C entry of kernels/csrc/cin.cu as many
    arguments as it declares (ctypes would refuse the call on the card only)."""
    text = (Path(t_cin.__file__).resolve().parent.parent / "kernels" / "csrc"
            / "cin.cu").read_text()
    for fn, (argtypes, _) in t_cin._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m and len(argtypes) == len(m.group(1).split(",")), fn


def test_dw_operands_lay_out_16_byte_runs():
    """In bf16 with K a multiple of 8 the weight-gradient kernel stages with
    16-byte copies: aligned [B, *, K] operands (and the K-major views of such
    memory) pass as they are, the model's y = looked[..., :K] (rows K+1
    apart) and K-major memory are copied into contiguous [B, *, K] tensors
    of the same values, an operand passed twice is copied once. With K=12
    every operand passes in place, for element copies; fp32, whose runs are
    4 rows, copies as bf16 does (test_dw_operands_fp32_copy_rule)."""
    bf = torch.bfloat16
    x = torch.randn(5, 26, 64).to(bf)
    y = torch.randn(5, 26, 65).to(bf)[..., :64]
    g = torch.randn(5, 64, 64).to(bf)
    (xo, yo, go), copies = t_cin.dw_operands(x, y, g, "legacy")
    assert copies and xo is x and go is g and yo.is_contiguous() and torch.equal(yo, y)
    (xo, yo, go), copies = t_cin.dw_operands(y, y, g, "legacy")
    assert copies and xo is yo and torch.equal(xo, y)
    views = [t.transpose(1, 2) for t in (x, y, g)]
    (xo, yo, go), copies = t_cin.dw_operands(*views, "kmajor")
    assert copies and xo.data_ptr() == x.data_ptr() and torch.equal(yo, y)
    memory = [t.transpose(1, 2).contiguous() for t in (x, y, g)]
    ops, copies = t_cin.dw_operands(*memory, "kmajor")
    assert copies and all(o.is_contiguous() for o in ops)
    assert all(torch.equal(o, t) for o, t in zip(ops, (x, y, g)))
    args = [t[..., :12] for t in (x, y, g)]
    ops, copies = t_cin.dw_operands(*args, "legacy")
    assert not copies and all(o is a for o, a in zip(ops, args))
    ops, copies = t_cin.dw_operands(*(t.float() for t in (x, y, g)), "legacy")
    assert copies and all(o.is_contiguous() for o in ops)


def _dw_emulated(x, y, g):
    """The bf16 kernel's walk in plain PyTorch, [B, *, K] operands: the
    fixed slices of dw_slices, each reduced in 64-row chunks of 16-row mma
    steps (a step's 16 rows in the kernel's slot order, 4t + [0, 4) for the
    four threads t) into fp32 tiles of 8 h x 32 m (M zero-padded) x 64 o;
    each product x*y rounded to bf16; the slices summed in order."""
    b, h, k = x.shape
    m, o = y.shape[1], g.shape[1]
    rows = b * k
    xr, yr, gr = (t.transpose(1, 2).reshape(rows, -1).float() for t in (x, y, g))
    slices, per = t_cin.dw_slices(rows)
    m_pad = -(-m // 32) * 32
    partial = torch.zeros(slices, h, m_pad, o)
    for s in range(slices):
        end = min(rows, (s + 1) * per)
        for c0 in range(s * per, end, 64):
            for r0 in range(c0, min(c0 + 64, end), 16):
                order = torch.tensor([r0 + 4 * t + e for t in range(4) for e in range(4)])
                order = order[order < end]
                kr = torch.zeros(len(order), h, m_pad)
                kr[:, :, :m] = (xr[order, :, None] * yr[order, None, :]).to(torch.bfloat16)
                partial[s] += torch.einsum("rhm,ro->hmo", kr, gr[order])
    dw = torch.zeros(h, m, o)
    for s in range(slices):
        dw += partial[s, :, :m]
    return dw


@pytest.mark.parametrize("b,k", [(37, 12), (37, 24), (9, 8)])
def test_emulated_dw_tiling_matches_plain(b, k):
    """The emulated walk, with B*K off the 64-row chunk (444 and 888 rows)
    and a slice of 72 rows, equals cin_dw_plain within the fp32 bound of
    its sum order, at H=26 (four 8-h blocks, the last with 2) and M=26
    (padded to 32)."""
    h, m, o = 26, 26, 8
    (_, xt), (_, yt), (_, gt) = _arrays("bfloat16", 6 + k, (b, h, k), (b, m, k), (b, o, k))
    got = _dw_emulated(xt, yt, gt)
    want = t_cin.cin_dw_plain(xt, yt, gt)
    z = (xt.double()[:, :, None, :] * yt.double()[:, None, :, :]).abs()
    mag = torch.einsum("bhmk,bok->hmo", z, gt.double().abs()).numpy()
    np.testing.assert_array_less(np.abs(got.numpy() - want.numpy()),
                                 2 * b * k * 2.0 ** -24 * mag + 1e-30)


# --- the bf16 contraction kernel's tiling, held on the CPU --------------------


def test_contraction_plan_fits_each_zoo_call():
    """The plan of each of the xDeepFM zoo step's six contraction calls, (H',
    M', O') of CIN (64, 64) over 26 fields: m padded to 32 (64 where M' = 64),
    the widest column group whose packed W fits in shared memory with the
    warps' tiles (O' = 26 rounds up to 32, not to 64), and no plan where
    M' > 64 (such shapes take the tile kernel)."""
    plans = {(26, 26, 64): (32, 8, 1), (64, 26, 26): (32, 4, 1), (64, 26, 64): (32, 4, 2),
             (64, 64, 26): (64, 2, 2)}
    for shape, plan in plans.items():
        assert t_cin.contraction_plan(*shape) == plan, shape
        mp, nt, _ = plan
        assert t_cin.contraction_smem(shape[0], mp, nt) <= 227 * 1024
        assert t_cin.contraction_smem(shape[0], mp, 2 * nt) > 227 * 1024 or 8 * nt >= shape[2]
    assert t_cin.contraction_plan(64, 65, 64) is None
    assert t_cin.contraction_plan(3, 4, 2) == (32, 1, 1)


def test_pack_weight_lays_out_the_column_groups():
    """pack_weight(w)[g, c, h * mp + m] = w[h, m, 8 nt g + c] from any
    strides, zero for m >= M and for columns past O."""
    w = torch.randn(5, 3, 26).permute(1, 2, 0)  # [3, 26, 5]: a permuted view, as dx passes
    wp = t_cin.pack_weight(w, 32, 2, 2)
    assert wp.shape == (2, 16, 3 * 32) and wp.is_contiguous()
    full = wp.reshape(32, 3, 32)
    assert torch.equal(full[:5, :, :26], w.permute(2, 0, 1))
    assert not full[5:].any() and not full[:, :, 26:].any()


def _cin_emulated(x, y, w):
    """The bf16 mma.sync kernel's walk in plain PyTorch, [B, *, K] operands:
    rows r = (b, k); W packed by pack_weight for contraction_plan; for each
    h, for each k16 step of m (padded to mp), the A fragment round(x[r, h] *
    y[r, m]) in bf16 (zero past M) times the group's B slice, summed into
    fp32 accumulators in (h, step) order; the result rounded to bf16."""
    b, h, k = x.shape
    m, o = y.shape[1], w.shape[2]
    mp, nt, groups = t_cin.contraction_plan(h, m, o)
    wp = t_cin.pack_weight(w.to(x.dtype), mp, nt, groups).float()  # [groups, 8 nt, h * mp]
    xr = x.transpose(1, 2).reshape(b * k, h)
    yr = torch.zeros(b * k, mp, dtype=x.dtype)
    yr[:, :m] = y.transpose(1, 2).reshape(b * k, m)
    out = torch.zeros(b * k, groups * 8 * nt)
    for g in range(groups):
        acc = torch.zeros(b * k, 8 * nt)
        for hh in range(h):
            for ks in range(mp // 16):
                a = (xr[:, hh, None] * yr[:, 16 * ks:16 * ks + 16]).float()  # rounded to bf16
                bslice = wp[g, :, hh * mp + 16 * ks:hh * mp + 16 * ks + 16]  # [8 nt, 16]
                acc += (a.double() @ bslice.double().T).float()
        out[:, g * 8 * nt:(g + 1) * 8 * nt] = acc
    return out[:, :o].to(x.dtype).reshape(b, k, o).transpose(1, 2)


@pytest.mark.parametrize("call", ["forward", "dx", "dy"])
def test_emulated_contraction_tiling_matches_plain(call):
    """The emulated walk of the three calls of a layer with H=64, M=26, O=26
    (forward (H', M', O') = (64, 26, 26), dx (26, 26, 64), dy (26, 64, 26):
    O' = 26 in a 32-wide group, M' = 64 padded to 64), B*K = 60 rows, off the
    kernel's 32-row tile: within the fp32 bound of its sum order of
    cin_plain, and of rectpu's _cin_pallas ("flat", interpret mode)."""
    b, h, m, o, k = 5, 64, 26, 26, 12
    (xj, xt), (yj, yt), (wj, wt), (gj, gt) = _arrays("bfloat16", 11, (b, h, k), (b, m, k),
                                                      (h, m, o), (b, o, k), scale=0.8)
    a, c, ww, aj, cj, wwj = {
        "forward": (xt, yt, wt, xj, yj, wj),
        "dx": (gt, yt, wt.permute(2, 1, 0), gj, yj, jnp.transpose(wj, (2, 1, 0))),
        "dy": (gt, xt, wt.permute(2, 0, 1), gj, xj, jnp.transpose(wj, (2, 0, 1))),
    }[call]
    got = _cin_emulated(a, c, ww)
    want = t_cin.cin_plain(a, c, ww)
    ref = _np(_cin_pallas(aj, cj, wwj, interpret=True, tile_b=8, variant="flat"))
    assert got.shape == want.shape == ref.shape and got.dtype == torch.bfloat16
    tol = _tol(_mag(a, c, ww), ww.shape[0] * ww.shape[1], _np(want), "bfloat16")
    np.testing.assert_array_less(np.abs(_np(got) - _np(want)), tol)
    np.testing.assert_array_less(np.abs(_np(got) - ref), tol + BF16_REL_ULP * np.abs(ref))


def test_contraction_operand_lays_out_16_byte_runs():
    """In bf16 with K a multiple of 32 the contraction kernel stages x with
    16-byte copies: an aligned [B, H, K] x (and the K-major view of such
    memory) passes as it is, the model's x0 = looked[..., :K] (rows K+1
    apart) and K-major memory are copied into contiguous [B, H, K] tensors
    of the same values. With K=24 or in fp32, x passes in place, for element
    loads."""
    bf = torch.bfloat16
    x = torch.randn(3, 26, 64).to(bf)
    xv, copies = t_cin.contraction_operand(x, "legacy")
    assert copies and xv is x
    looked = torch.randn(3, 26, 65).to(bf)[..., :64]
    xv, copies = t_cin.contraction_operand(looked, "legacy")
    assert copies and xv.is_contiguous() and torch.equal(xv, looked)
    xv, copies = t_cin.contraction_operand(x.transpose(1, 2), "kmajor")
    assert copies and xv.data_ptr() == x.data_ptr() and torch.equal(xv, x)
    xv, copies = t_cin.contraction_operand(x.transpose(1, 2).contiguous(), "kmajor")
    assert copies and xv.is_contiguous() and torch.equal(xv, x)
    for arg in (x[..., :24], x.float()):
        xv, copies = t_cin.contraction_operand(arg, "legacy")
        assert not copies and xv is arg


# --- the fp32 kernels (3xTF32 on mma.sync), held on the CPU -------------------


def _low13(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_split_reconstructs_within_2_to_the_minus_22():
    """split_tf32 (cvt.rna.tf32.f32's rounding): hi and lo have their low 13
    mantissa bits zero, hi + lo is within 2^-22 |v| of v (2^-137, half of
    TF32's step there, for the subnormal values), and a tie rounds away
    from zero."""
    rng = np.random.default_rng(12)
    v = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096))
                         .astype(np.float32))
    v = torch.cat([v, torch.tensor([0.0, -0.0, 1.0, -3.0, 1e-40, -1e-40, 3.4e38])])
    hi, lo = t_cin.split_tf32(v)
    assert not _low13(hi).any() and not _low13(lo).any()
    err = (v.double() - hi.double() - lo.double()).abs()
    assert bool((err <= torch.clamp(2.0 ** -22 * v.double().abs(), min=2.0 ** -137)).all())
    assert bool((err[:4096] <= 2.0 ** -22 * v[:4096].double().abs()).all())
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23])
    assert t_cin.tf32_round(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(t_cin.tf32_round(inf), inf)


def test_fp32_contraction_plan_fits_each_zoo_call():
    """The fp32 plan of each of the xDeepFM zoo step's six contraction calls:
    (H', M') = (64, 26) runs as (26, 64) (swap_tf32: 26 h by 64 m, no
    padding, in place of 64 by 26 padded to 32), m padded to 32 (64 where
    M' = 64), one group of all columns (O' = 26 rounds up to 32), W streamed
    by h through 4 stages that fit in shared memory whatever H' is; no plan
    where M' > 64; O' > 64 in groups of 64."""
    plans = {(26, 26, 64): (32, 8, 1), (64, 26, 26): (64, 4, 1), (64, 26, 64): (64, 8, 1),
             (64, 64, 26): (64, 4, 1)}
    for (h, m, o), plan in plans.items():
        swap = t_cin.swap_tf32(h, m)
        assert swap == (m == 26 and h == 64), (h, m)
        if swap:
            h, m = m, h
        assert t_cin.contraction_plan_tf32(h, m, o) == plan, (h, m, o)
        assert t_cin.contraction_smem_tf32(*plan[:2]) <= 227 * 1024
    assert t_cin.contraction_plan_tf32(64, 26, 64) == (32, 8, 1)
    assert not t_cin.swap_tf32(8, 80) and not t_cin.swap_tf32(64, 64)
    assert t_cin.contraction_smem_tf32(64, 8) <= 227 * 1024  # the largest stage
    assert t_cin.contraction_plan_tf32(64, 65, 64) is None
    assert t_cin.contraction_plan_tf32(3, 4, 2) == (32, 1, 1)
    assert t_cin.contraction_plan_tf32(8, 40, 130) == (64, 8, 3)


def test_pack_weight_tf32_lays_out_split_pairs():
    """pack_weight_tf32(w)[g, h, c, j] = (hi, hi, lo, lo) of w[h, 2j, o],
    w[h, 2j + 1, o] for o = 8 nt g + c, from any strides; zero for m >= M
    and for columns past O."""
    w = torch.randn(5, 3, 26).permute(1, 2, 0)  # [3, 26, 5]: a permuted view, as dx passes
    wp = t_cin.pack_weight_tf32(w, 32, 1, 1)
    assert wp.shape == (1, 3, 8, 16, 4) and wp.is_contiguous()
    hi, lo = t_cin.split_tf32(w.contiguous())
    planes = wp[0].reshape(3, 8, 16, 2, 2)  # [h, c, j, plane, m parity]
    for plane, want in ((0, hi), (1, lo)):
        got = planes[:, :, :, plane, :].reshape(3, 8, 32)  # [h, c, m]
        assert torch.equal(got[:, :5, :26], want.permute(0, 2, 1))
        assert not got[:, 5:].any() and not got[:, :, 26:].any()


def _split64(t):
    hi, lo = t_cin.split_tf32(t.float().contiguous())
    return hi.double(), lo.double()


def _mma3(acc, a, b):
    """acc [R, N] fp32 += a [R, 8] * b [N, 8]^T in the kernels' 3xTF32 order,
    a and b each an fp32 tensor to split or a split (hi, lo) pair: lo*hi,
    hi*lo, hi*hi, each mma's 8 exact products added to the accumulator and
    rounded to fp32."""
    (a_hi, a_lo), (b_hi, b_lo) = (t if isinstance(t, tuple) else _split64(t) for t in (a, b))
    for u, v in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
        acc = (acc.double() + u @ v.T).float()
    return acc


def _cin_tf32_emulated(x, y, w):
    """The fp32 contraction kernel's walk in plain PyTorch, [B, *, K]
    operands: rows r = (b, k); W split and packed by pack_weight_tf32 for
    contraction_plan_tf32; for each group, h, and k8 step of m (padded to
    mp), the products x[r, h] * y[r, m] rounded to fp32 times the group's
    split B slice as three TF32 products, in (h, step) order; x and y in the
    wrapper's order (swap_tf32)."""
    if t_cin.swap_tf32(x.shape[1], y.shape[1]):
        x, y, w = y, x, w.permute(1, 0, 2)
    b, h, k = x.shape
    m, o = y.shape[1], w.shape[2]
    mp, nt, groups = t_cin.contraction_plan_tf32(h, m, o)
    wp = t_cin.pack_weight_tf32(w.float(), mp, nt, groups)  # [groups, h, 8 nt, mp / 2, 4]
    w_hi = wp[..., :2].reshape(groups, h, 8 * nt, mp).double()
    w_lo = wp[..., 2:].reshape(groups, h, 8 * nt, mp).double()
    xr = x.transpose(1, 2).reshape(b * k, h)
    yr = torch.zeros(b * k, mp)
    yr[:, :m] = y.transpose(1, 2).reshape(b * k, m)
    out = torch.zeros(b * k, groups * 8 * nt)
    for g in range(groups):
        acc = torch.zeros(b * k, 8 * nt)
        for hh in range(h):
            for ks in range(mp // 8):
                a = xr[:, hh, None] * yr[:, 8 * ks:8 * ks + 8]  # fp32 products
                cols = slice(8 * ks, 8 * ks + 8)
                acc = _mma3(acc, a, (w_hi[g, hh, :, cols], w_lo[g, hh, :, cols]))
        out[:, g * 8 * nt:(g + 1) * 8 * nt] = acc
    return out[:, :o].reshape(b, k, o).transpose(1, 2)


@pytest.mark.parametrize("variant", ["flat", "mloop"])
@pytest.mark.parametrize("call", ["forward", "dx", "dy"])
def test_emulated_fp32_contraction_matches_cin_pallas(call, variant):
    """The fp32 kernel's arithmetic, emulated, for the three calls of a layer
    with H=64, M=26, O=26 ((H', M', O') = (64, 26, 26), swapped to (26, 64,
    26); (26, 26, 64); (26, 64, 26): m padded to 32 or 64, O' = 26 in a
    32-wide group), B*K = 60 rows: within the fp32 bound of the summed terms
    of cin_plain and of rectpu's _cin_pallas in interpret mode."""
    b, h, m, o, k = 5, 64, 26, 26, 12
    (xj, xt), (yj, yt), (wj, wt), (gj, gt) = _arrays("float32", 13, (b, h, k), (b, m, k),
                                                      (h, m, o), (b, o, k), scale=0.8)
    a, c, ww, aj, cj, wwj = {
        "forward": (xt, yt, wt, xj, yj, wj),
        "dx": (gt, yt, wt.permute(2, 1, 0), gj, yj, jnp.transpose(wj, (2, 1, 0))),
        "dy": (gt, xt, wt.permute(2, 0, 1), gj, xj, jnp.transpose(wj, (2, 0, 1))),
    }[call]
    got = _cin_tf32_emulated(a, c, ww)
    want = t_cin.cin_plain(a, c, ww)
    ref = _np(_cin_pallas(aj, cj, wwj, interpret=True, tile_b=8, variant=variant))
    assert got.shape == want.shape == ref.shape and got.dtype == torch.float32
    tol = _tol(_mag(a, c, ww), ww.shape[0] * ww.shape[1], _np(want), "float32")
    np.testing.assert_array_less(np.abs(_np(got) - _np(want)), tol)
    np.testing.assert_array_less(np.abs(_np(got) - ref), tol)


def _dw_tf32_emulated(x, y, g):
    """The fp32 weight-gradient kernel's walk in plain PyTorch, [B, *, K]
    operands: the fixed slices of dw_slices, each in 64-row chunks summed
    from zero in 8-row steps (three TF32 products of the fp32 products x*y
    and g, lo*hi, hi*lo, hi*hi), the chunks added in fp32, the slices
    summed in order."""
    b, h, k = x.shape
    m, o = y.shape[1], g.shape[1]
    rows = b * k
    xr, yr, gr = (t.transpose(1, 2).reshape(rows, -1) for t in (x, y, g))
    slices, per = t_cin.dw_slices(rows)
    partial = torch.zeros(slices, h * m, o)
    for s in range(slices):
        end = min(rows, (s + 1) * per)
        for c0 in range(s * per, end, 64):
            part = torch.zeros(h * m, o)
            for r0 in range(c0, min(c0 + 64, end), 8):
                rr = slice(r0, min(r0 + 8, end))
                kr = (xr[rr, :, None] * yr[rr, None, :]).reshape(-1, h * m)  # fp32 products
                part = _mma3(part, kr.T, gr[rr].T)
            partial[s] += part
    dw = torch.zeros(h * m, o)
    for s in range(slices):
        dw += partial[s]
    return dw.reshape(h, m, o)


@pytest.mark.parametrize("b,k", [(37, 12), (9, 8), (7, 6)])
def test_emulated_fp32_dw_matches_cin_dw_pallas(b, k):
    """The fp32 weight-gradient kernel's arithmetic, emulated, with B*K off
    the 64-row chunk (444, 72 and 42 rows), against cin_dw_plain and
    rectpu's _cin_dw_pallas in interpret mode, within the fp32 bound of
    test_plain_dw_matches_cin_dw_pallas."""
    h, m, o = 26, 26, 8
    (xj, xt), (yj, yt), (gj, gt) = _arrays("float32", 14 + k, (b, h, k), (b, m, k), (b, o, k))
    got = _dw_tf32_emulated(xt, yt, gt)
    want = t_cin.cin_dw_plain(xt, yt, gt)
    ref = np.asarray(_cin_dw_pallas(xj, yj, gj, interpret=True, tile_b=8))
    z = (xt.double()[:, :, None, :] * yt.double()[:, None, :, :]).abs()
    tol = 2 * b * k * 2.0 ** -24 * torch.einsum("bhmk,bok->hmo", z, gt.double().abs()).numpy()
    np.testing.assert_array_less(np.abs(got.numpy() - want.numpy()), tol + 1e-30)
    np.testing.assert_array_less(np.abs(got.numpy() - ref), tol + 1e-30)


def test_dw_operands_fp32_copy_rule():
    """In fp32 the weight-gradient kernel stages 4-row runs with 16-byte
    copies when K is a multiple of 4: aligned operands pass as they are, the
    model's y = looked[..., :K] and K-major memory are copied into
    contiguous [B, *, K] tensors of the same values (x = y passed twice is
    copied once); K=6 passes every operand in place, for element copies."""
    x = torch.randn(5, 26, 64)
    y = torch.randn(5, 26, 65)[..., :64]
    g = torch.randn(5, 64, 64)
    (xo, yo, go), copies = t_cin.dw_operands(x, y, g, "legacy")
    assert copies and xo is x and go is g and yo.is_contiguous() and torch.equal(yo, y)
    (xo, yo, go), copies = t_cin.dw_operands(y, y, g, "legacy")
    assert copies and xo is yo and torch.equal(xo, y)
    memory = [t.transpose(1, 2).contiguous() for t in (x, y, g)]
    ops, copies = t_cin.dw_operands(*memory, "kmajor")
    assert copies and all(o.is_contiguous() for o in ops)
    assert all(torch.equal(o, t) for o, t in zip(ops, (x, y, g)))
    x4 = torch.randn(5, 26, 4)  # the CLI's default K=4: one run a batch row
    (xo, _, _), copies = t_cin.dw_operands(x4, x4, x4, "legacy")
    assert copies and xo is x4
    args = [t[..., :6] for t in (x, y, g)]
    ops, copies = t_cin.dw_operands(*args, "legacy")
    assert not copies and all(o is a for o, a in zip(ops, args))
