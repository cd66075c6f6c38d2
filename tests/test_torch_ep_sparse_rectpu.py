"""The port's sparse EP update (``parallel/sparse_ep.py``) against rectpu's
(``rectpu/parallel/sparse_ep.py``) on 1x2 and 2x2 meshes, rectpu on its
virtual CPU devices, the port's ranks spawned over Gloo
(``tests/torch_mp_worker.py``), from the same numpy-seeded inputs:

  - ``make_sparse_rows_ep`` alone, one lazy-Adam update of a [64, 5] table
    and its packed m|v slab, under the 1d, 2d and dedup exchanges and a
    starved peer capacity of 2 (which drops the same updates in both);
  - the sparse fast step (``make_sparse_step(plan=...)``, packed DeepFM),
    three steps at lr 0.01 from the port's seeded init.

Tolerances: the update alone, table and m|v rtol 1e-6, atol 1e-6: each
touched row's cotangents are summed per rank and again across ranks in
another fp32 order (v > 0.01 here, so Adam does not amplify it). The fast
step: losses rtol 1e-6, parameters atol 1e-4 and the m|v slab atol 1e-7, the
bounds ``tests/test_torch_sparse_ep.py`` states for sharded against single
steps (Adam near eps moves a parameter by lr/eps times a gradient's
fp32-order error).
"""

import numpy as np
import pytest

from torch_ep_checks import rectpu_sparse_rows, rectpu_sparse_steps
from torch_mp_worker import SPARSE_ROWS_CASES, run_ranks

MESHES = [(1, 2), (2, 2)]
MODES = ("1d", "2d", "dedup")
ROWS_RTOL = ROWS_ATOL = 1e-6
LOSS_RTOL, PARAM_ATOL, MV_ATOL = 1e-6, 1e-4, 1e-7


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, tmp_path_factory):
    d, m = request.param
    tmp = tmp_path_factory.mktemp("ranks")
    rows = run_ranks("sparse_rows", d * m, tmp, num_data=d, num_model=m)
    steps = run_ranks("sparse_steps", d * m, tmp, num_data=d, num_model=m, modes=MODES)
    return (d, m), rows, steps[0]


@pytest.mark.parametrize("case", SPARSE_ROWS_CASES, ids=lambda c: c[0])
def test_sparse_rows_equal_rectpus(ranks, case):
    (d, m), rows, _ = ranks
    name, mode, cap = case
    for r in range(d * m):  # the 'data' replicas of a shard apply the same update
        for k in ("table", "mv"):
            np.testing.assert_array_equal(rows[r][name][k], rows[r % m][name][k])
    got = {k: np.concatenate([rows[i][name][k] for i in range(m)]) for k in ("table", "mv")}
    table, mv = rectpu_sparse_rows((d, m), mode, cap)
    np.testing.assert_allclose(got["table"], table, rtol=ROWS_RTOL, atol=ROWS_ATOL)
    np.testing.assert_allclose(got["mv"], mv, rtol=ROWS_RTOL, atol=ROWS_ATOL)


def test_starved_capacity_drops_updates(ranks):
    """The starved case really drops updates: fewer rows move than lossless."""
    (_, m), rows, _ = ranks
    from torch_mp_worker import sparse_rows_inputs

    table = sparse_rows_inputs()[0]
    moved = {name: int((np.concatenate([rows[i][name]["table"] for i in range(m)])
                        != table).any(axis=1).sum())
             for name in ("dedup", "dedup_starved")}
    assert 0 < moved["dedup_starved"] < moved["dedup"], moved


@pytest.mark.parametrize("mode", MODES)
def test_sparse_fast_step_equals_rectpus(ranks, mode):
    mesh, _, steps = ranks
    losses, params, mv = rectpu_sparse_steps(mesh, mode)
    got = steps[mode]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert sorted(got["params"]) == sorted(params)
    for k, want in params.items():
        np.testing.assert_allclose(got["params"][k], want, rtol=0, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(got["mv"], mv, rtol=0, atol=MV_ATOL)
