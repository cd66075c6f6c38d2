"""Sharded training steps of the port against its single-process steps, on
1x2 and 2x2 meshes of Gloo ranks (``tests/torch_mp_worker.py``):

  - three dense Adam steps through ``Trainer.train_step`` with a
    ``ParallelPlan`` under the 1d, 2d and dedup exchanges, for DeepFM (dropout
    off, and hash dropout at 0.5, whose masks key on global rows), DeepFM in
    the flat layout with the mxu backward, and every other family with a
    table (DLRM, xDeepFM, Wide&Deep, DNN, DCN, AutoInt; flat forms too);
    each rank runs the single-process steps on the whole batch beside its
    sharded ones;
  - three sparse lazy-Adam fast steps (``make_sparse_step(plan=...)``,
    ``parallel/sparse_ep.py``) against the single fast step (rectpu's
    ``tests/test_sparse_ep.py:49-140``).

Tolerances: per-step losses rtol 1e-6 (the global loss is the ranks' shares
summed in another order); parameters atol 1e-4 and the m|v slab atol 1e-7
after three steps at lr 0.01: the gradients sum over the batch ranks (and,
in the sparse step, each row's cotangents dedup per rank and again across
ranks) in another fp32 order, a few ulp of a gradient sum. Adam's step is
lr*m/(sqrt(v)+eps), so where a gradient is near eps (1e-8) it moves a
parameter by lr/eps = 1e6 times the gradient's own error: about 1e-5 a step
for an ulp of a 1e-4 sum, at most 3e-5 over three steps (seen: 2.6e-5 on
one of 16,896 xDeepFM table entries). The 1d exchange on one data row gives
the single step bit for bit.
"""

import numpy as np
import pytest

from torch_mp_worker import run_ranks, step_configs

MESHES = [(1, 2), (2, 2)]
MODES = ("1d", "2d", "dedup")
LOSS_RTOL, PARAM_ATOL, MV_ATOL = 1e-6, 1e-4, 1e-7


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, tmp_path_factory):
    d, m = request.param
    tmp = tmp_path_factory.mktemp("steps")
    return ((d, m), run_ranks("steps", d * m, tmp, num_data=d, num_model=m),
            run_ranks("sparse_steps", d * m, tmp, num_data=d, num_model=m))


def _same_on_every_rank(results, pick):
    for r in results[1:]:
        a, b = pick(results[0]), pick(r)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("config", list(step_configs()))
def test_sharded_step_equals_single_step(ranks, config, mode):
    mesh, steps, _ = ranks
    _same_on_every_rank(steps, lambda r: r[config][mode])
    got = steps[0][config]
    np.testing.assert_allclose(got[mode + "_losses"], got["single_losses"], rtol=LOSS_RTOL)
    for key, ref in got["single"].items():
        if mode == "1d" and mesh[0] == 1:
            np.testing.assert_array_equal(got[mode][key], ref, err_msg=key)
        else:
            np.testing.assert_allclose(got[mode][key], ref, rtol=0, atol=PARAM_ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("mode", MODES)
def test_sparse_ep_step_equals_single_fast_step(ranks, mode):
    _, _, sparse = ranks
    _same_on_every_rank(sparse, lambda r: r[mode]["params"])
    got, ref = sparse[0][mode], sparse[0]["None"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    for key in ref["params"]:
        np.testing.assert_allclose(got["params"][key], ref["params"][key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    np.testing.assert_allclose(got["mv"], ref["mv"], rtol=0, atol=MV_ATOL)
