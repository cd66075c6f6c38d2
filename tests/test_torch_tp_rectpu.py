"""The port's tensor-parallel towers (``--tp-mlp``) against rectpu's: the
port's sharded Trainer steps under ``ParallelPlan(tp_mlp=True)`` against
rectpu's sharded ``Trainer._train_one`` under its TP plan on the same 1x2
mesh. DeepFM plain and flat under the 1d and 2d exchanges (hash dropout 0.1
in the plain 1d and the flat 2d cases, seeded with rectpu's step seeds, so
the masks are rectpu's bit for bit, a column shard's included), DLRM (its
bottom MLP row-parallel, replicated, then column-parallel at its last
layer; its top MLP) and DCN (its top MLP) under 2d. The 2x2 mesh, the fast
step and the bf16 towers are in ``tests/test_torch_tp_rectpu_more.py``.

The port's ranks are spawned processes over Gloo (``tests/torch_mp_worker.py``
``tp_case_results``); rectpu runs here on its virtual CPU devices. Both start
from the port's seeded init and take the same numpy-seeded batches: three
Adam steps at lr 0.01, fp32.

Tolerances, as ``tests/test_torch_ep_steps_rectpu.py`` states them (another
fp32 order of sums; Adam's step magnifies a near-eps gradient's error by
lr/eps): per-step losses rtol 1e-6, parameters atol 1e-4. Seen: losses
within 2.0e-7, parameters within 2.3e-5 (the flat 1d case's mlp/0/kernel).
"""

import pytest

from torch_ep_checks import check_tp_against_rectpu, tp_ranks

MESH = (1, 2)
CASES = ("deepfm_1d", "deepfm_2d", "deepfm_flat_1d", "deepfm_flat_2d", "dlrm_2d", "dcn_2d")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tp_ranks(MESH, tmp_path_factory.mktemp("ranks"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_tp_step_equals_rectpus_tp_step(ranks, name):
    check_tp_against_rectpu(MESH, ranks, name)
