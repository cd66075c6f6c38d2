"""The port's flat FM (rectpu's lane-packed ``fm_cross_flat*``) against rectpu.

The plain versions of the two flat kernels (``fm_cross_flat_plain``, the
forward's fp32 logit and its S in v2's dtype; ``fm_cross_flat_bwd_plain``,
dv2 from the stored S) are held against rectpu's Pallas pair run in
interpret mode on the CPU, on the same inputs made with numpy from a seed.
The CUDA kernels run only on the card: ``chip_smoke.py`` holds them against
these plain versions there.

Tolerances: fp32 values as rectpu's own test of the flat Pallas FM
(``tests/test_ops.py``: rtol 1e-4, atol 1e-5; sums in another order). The
fp32 logit is the difference of two fp32 sums, sum_k S^2 and sum Q, each of
which one order of summation may put an ulp or two from the other's, so it
is held to rtol 1e-4, atol 1e-5 plus two fp32 ulps of the larger sum (at
F=26, K=64 the sums reach ~500, whose ulp is 6.1e-5, while a logit can
cancel to ~0.5). bf16 S and dv2 within one bf16 ulp (both sides sum in fp32
and round once, and the two fp32 sums may round to neighbouring bf16
values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.ops.fm import _fm_flat_pallas_bwd, _fm_flat_pallas_fwd
from rectpu.ops.fm import fm_cross_flat as jax_fm_cross_flat
from rectpu.ops.fm import fm_cross_flat_dispatch as jax_dispatch
from rectpu.ops.fm import fm_cross_flat_pallas as jax_fm_cross_flat_pallas
from rectpu_torch.ops import fm as t_fm

DTYPES = {"float32": (np.float32, jnp.float32), "bfloat16": (jnp.bfloat16, jnp.bfloat16)}
# (B, F, K): the ml-100k width, a narrow one, and a ragged batch over two of
# rectpu's batch tiles (2048 rows at F*K = 128 fp32)
SHAPES = [(48, 26, 64), (37, 4, 32), (2100, 1, 128)]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _restore_flat_pin():
    saved = dict(t_fm._FLAT_AUTO)
    yield
    t_fm._FLAT_AUTO.clear()
    t_fm._FLAT_AUTO.update(saved)


def _inputs(b, f, k, dtype, seed):
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    v2 = rng.normal(0.0, 0.5, (b, f * k)).astype(np.float32).astype(np_dt)
    g = rng.normal(size=b).astype(np.float32)
    return v2, g


def _t(x) -> torch.Tensor:
    """numpy (fp32 or bf16) -> torch tensor of the same type and bits."""
    x = np.asarray(x)
    if x.dtype == np.float32:
        return torch.from_numpy(x.copy())
    return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place (ordered bit patterns)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).long()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((ordered(a) - ordered(b)).abs().max())


def _close_logit(got: torch.Tensor, want, v2: torch.Tensor, f: int, k: int) -> None:
    """The fp32 logit: rtol 1e-4, atol 1e-5 and two fp32 ulps of the larger
    of the two sums it is the difference of (see the module docstring)."""
    v64 = v2.double().reshape(v2.shape[0], f, k)
    larger = np.maximum((v64.sum(1) ** 2).sum(-1).numpy(), (v64 ** 2).sum((1, 2)).numpy())
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = RTOL * np.abs(want) + ATOL + 2 * np.spacing(larger.astype(np.float32))
    assert np.all(np.abs(got.numpy() - want) <= tol)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "float32" or got.dtype == torch.float32:
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=RTOL, atol=ATOL)
    else:
        assert _ulps(got, want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,f,k", SHAPES)
def test_flat_plain_matches_rectpu_pallas(b, f, k, dtype):
    """Forward (out, S) and backward (dv2 from rectpu's stored S) of the
    plain versions against rectpu's ``_fm_flat_fwd_kernel`` and
    ``_fm_flat_bwd_kernel`` in interpret mode."""
    _, jnp_dt = DTYPES[dtype]
    v2, g = _inputs(b, f, k, dtype, seed=b + f + k)
    want_out, want_s = _fm_flat_pallas_fwd(jnp.asarray(v2, jnp_dt), f, k, True)
    got_out, got_s = t_fm.fm_cross_flat_plain(_t(v2), f, k)
    _close_logit(got_out, want_out, _t(v2), f, k)
    _close(got_s, want_s, dtype)
    want_dv = _fm_flat_pallas_bwd(jnp.asarray(v2, jnp_dt), want_s, jnp.asarray(g), f, k, True)
    got_dv = t_fm.fm_cross_flat_bwd_plain(_t(v2), _t(want_s), torch.from_numpy(g), f, k)
    _close(got_dv, want_dv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_pallas_route_value_and_grad_match_rectpu(dtype):
    """The "pallas" route end to end: the port's autograd Function saves the
    forward's S and its backward reads it, as rectpu's custom VJP does."""
    _, jnp_dt = DTYPES[dtype]
    b, f, k = 48, 26, 64
    v2, g = _inputs(b, f, k, dtype, seed=5)
    out_j, vjp = jax.vjp(lambda x: jax_fm_cross_flat_pallas(x, f, k, True),
                         jnp.asarray(v2, jnp_dt))
    (dv_j,) = vjp(jnp.asarray(g))
    x = _t(v2).requires_grad_()
    out_t = t_fm.fm_cross_flat_pallas(x, f, k)
    out_t.backward(torch.from_numpy(g))
    _close_logit(out_t.detach(), out_j, _t(v2), f, k)
    _close(x.grad, dv_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_xla_route_matches_rectpu_fm_cross_flat(dtype):
    """The "xla" route against rectpu's ``fm_cross_flat``: the fp32 logit
    within the fp32 tolerance. Its backward keeps the fp32 S, where rectpu's
    XLA form rounds g, S, S - v2 and the product to v2's dtype (a documented
    deviation): fp32 within the fp32 tolerance; bf16 within five bf16
    roundings (unit 2^-8: four on rectpu's side, one on the port's) of
    |g| * (|S| + |v2|), which bounds every term rounded, and a sixth for
    second-order terms (measured: at most 3.4 units)."""
    _, jnp_dt = DTYPES[dtype]
    b, f, k = 37, 4, 32
    v2, g = _inputs(b, f, k, dtype, seed=11)
    out_j, vjp = jax.vjp(lambda x: jax_fm_cross_flat(x, f, k), jnp.asarray(v2, jnp_dt))
    (dv_j,) = vjp(jnp.asarray(g))
    x = _t(v2).requires_grad_()
    out_t = t_fm.fm_cross_flat(x, f, k)
    out_t.backward(torch.from_numpy(g))
    _close_logit(out_t.detach(), out_j, _t(v2), f, k)
    if dtype == "float32":
        _close(x.grad, dv_j, dtype)
    else:
        v64 = _t(v2).double().reshape(b, f, k)
        scale = np.abs(g)[:, None, None] * (v64.sum(1, keepdim=True).abs() + v64.abs()).numpy()
        err = np.abs(x.grad.double().numpy() - _t(dv_j).double().numpy()).reshape(b, f, k)
        assert np.all(err <= 6 * 2.0 ** -8 * scale)


@pytest.mark.parametrize("impl", ["pallas", "xla", "auto"])
@pytest.mark.parametrize("f,k", [(4, 32), (3, 40)])  # F*K = 128, and 120: not a lane tile
def test_flat_dispatch_chooses_as_rectpu(f, k, impl):
    """``fm_cross_flat_dispatch`` takes the route rectpu's does: "pallas"
    only where F*K % 128 == 0, else "xla"; "auto" through the pin (default
    "xla", here also set to "pallas"). Each route's value and gradient are
    its own function's, and the value matches rectpu's dispatcher."""
    b = 37
    v2, g = _inputs(b, f, k, "float32", seed=f * k)
    for pin in ("xla", "pallas"):
        t_fm.set_flat_auto_impl(pin, "cpu")
        route = pin if impl == "auto" else impl
        takes_pallas = route == "pallas" and (f * k) % 128 == 0
        own = t_fm.fm_cross_flat_pallas if takes_pallas else t_fm.fm_cross_flat
        x, y = _t(v2).requires_grad_(), _t(v2).requires_grad_()
        got, want = t_fm.fm_cross_flat_dispatch(x, f, k, impl), own(y, f, k)
        (got * torch.from_numpy(g)).sum().backward()
        (want * torch.from_numpy(g)).sum().backward()
        assert torch.equal(got, want) and torch.equal(x.grad, y.grad)
        if impl != "auto":
            _close_logit(got.detach(), jax_dispatch(jnp.asarray(v2), f, k, impl), _t(v2), f, k)


def test_flat_checks_and_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="xla"):
        t_fm.set_flat_auto_impl("mxu", "cpu")
    with pytest.raises(ValueError, match=r"\[B, 4\*32\]"):
        t_fm.fm_cross_flat_plain(torch.zeros(2, 100), 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        t_fm.fm_cross_flat_cuda(torch.zeros(2, 128), 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        t_fm.fm_cross_flat_bwd_cuda(torch.zeros(2, 128), torch.zeros(2, 32), torch.zeros(2),
                                    4, 32)
