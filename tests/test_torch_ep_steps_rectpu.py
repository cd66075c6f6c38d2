"""The port's sharded DeepFM Trainer steps against rectpu's sharded Trainer
steps (``Trainer._train_one`` under rectpu's ``ParallelPlan``) on the same
mesh: 1x2 and 2x2, the 1d, 2d and dedup exchanges, the plain and the flat
layout (the flat one with the xla backward, whose mxu twin is held against
rectpu at the lookup in ``tests/test_torch_ep_mxu.py``).

The port's ranks are spawned processes over Gloo (``tests/torch_mp_worker.py``);
rectpu runs here on its virtual CPU devices. Both start from the port's
seeded init and take the same numpy-seeded batches: three Adam steps at
lr 0.01, fp32, dropout off.

Tolerances (``tests/test_torch_sparse_ep.py`` states the same bounds of its
sharded-vs-single check): per-step losses rtol 1e-6; parameters atol 1e-4.
The two packages sum each gradient in another fp32 order (the towers' GEMMs,
a row's cotangents per shard and then over the ranks), a few ulp of a sum;
Adam's step lr*m/(sqrt(v)+eps) moves a parameter whose gradient is near eps
by lr/eps times that error. Seen: losses within 2e-7, parameters within
3.1e-5 (2x2 flat 2d), where the two packages' single-process steps differ by
2.3e-5 and rectpu's sharded step differs from its own single step by 3.5e-6.
"""

import pytest

from torch_ep_checks import check_dense_against_rectpu, dense_ranks

MESHES = [(1, 2), (2, 2)]
FLAT = {"flat_layout": True, "packed_linear": True, "scatter_impl": "xla"}
# (name, family, TowerConfig kwargs, model kwargs, bf16 slots, ep_mode)
CASES = tuple((f"{name}_{mode}", "deep_fm", cfg, {}, False, mode)
              for name, cfg in (("deepfm", {}), ("deepfm_flat", FLAT))
              for mode in ("1d", "2d", "dedup"))


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, tmp_path_factory):
    return request.param, dense_ranks(request.param, tmp_path_factory.mktemp("ranks"), CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sharded_step_equals_rectpus_sharded_step(ranks, case):
    check_dense_against_rectpu(*ranks, case)
