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
    assert t_cin.dw_slices(524_288) == (128, 4096) and t_cin.dw_slices(100) == (1, 128)
