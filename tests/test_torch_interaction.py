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
