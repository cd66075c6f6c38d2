"""The measured size of the port's deliberate sharded deviations (ROADMAP.md
queue C, "Sharded numerics"), each in the configuration that shows it, and
the check of one that was repaired: the
port's sharded DeepFM Trainer steps against rectpu's sharded steps on the
same mesh under the 2d exchange, and, as the baseline, the two packages'
single-process steps in the same configuration. Three Adam steps at lr 0.01
from the port's seeded init, dropout off (``tests/torch_mp_worker.py``
spawns the port's ranks over Gloo; rectpu runs on its virtual CPU devices).

  (a) flat layout, bf16 towers, 1x2: the port casts the flat exchange's
      rows to bf16 as its unsharded gather does; rectpu's flat exchange
      feeds fp32 rows. The port's sharded first-step loss equals its single
      one; rectpu's sharded one differs from its own by 6.1e-4.
  (b) table_grad_dtype bf16, 2x2: the port rounds a table shard's gradient
      after the sum over 'data'; rectpu's exchanges do not round it.
  (d) bf16 m and stochastically rounded v, 1x2: repaired. Both packages key
      the rounding on the global array's flat index (the port through
      ``ParallelPlan.sr_index``), so the sharded table update is as close to
      rectpu's sharded run as the single-process update is to rectpu's
      single run (both 0 on the CPU; it read 1.45e-3 while the port keyed
      on the shard's own indices).
  (e) bf16 towers, 1x2: each rank's bf16 weight gradient is rounded before
      the sum over ranks.

Each case holds, port against rectpu, sharded and (baseline) single: the
per-step loss relative error, the table leaves' update relative L2 (the
[V, ...] leaves: ``table``, ``emb``, ``linear/w``) and the largest leaf's.
The bounds are twice the values measured on the CPU (in the comments),
since these configurations round to bf16 and an Adam step from a gradient
near zero takes the other sign where one rounding lands apart (the largest
leaf is then a 16-element bias).
"""

import numpy as np
import pytest

from torch_ep_checks import (dense_ranks, flat_numpy, port_init, rectpu_dense_steps,
                             update_rel_l2)

FLAT = {"flat_layout": True, "packed_linear": True, "scatter_impl": "xla"}
# mesh: (name, family, TowerConfig kwargs, model kwargs, bf16 slots, ep_mode)
CASES = {
    (1, 2): (("a_flat_cast", "deep_fm", {**FLAT, "compute_dtype": "bfloat16"}, {}, False, "2d"),
             ("d_sr_slots", "deep_fm", {}, {}, True, "2d"),
             ("e_bf16_wgrad", "deep_fm", {"compute_dtype": "bfloat16"}, {}, False, "2d")),
    (2, 2): (("b_table_grad", "deep_fm", {"table_grad_dtype": "bfloat16"}, {}, False, "2d"),),
}
TABLE_LEAVES = ("table", "emb", "linear/w")
# name: (sharded bounds, single bounds), each (loss rel, table update rel L2,
# largest leaf's update rel L2); seen on the CPU, sharded | single:
#   a: loss 1.06e-3 | 7.0e-5, table 5.1e-3 | 1.1e-3, leaf 0.288 | 0.155
#   b: loss 5.3e-6 | 7.1e-6, table 2.3e-4 | 3.5e-4, leaf 2.3e-4 | 3.5e-4
#   d: loss 9.3e-8 | 1.9e-7, table 0 | 0, leaf 8.7e-5 | 8.3e-5
#   e: loss 1.40e-3 | 1.40e-3, table 0.0433 | 0.0433, leaf 0.285 | 0.285
BOUNDS = {
    "a_flat_cast": ((2.5e-3, 0.012, 0.6), (2e-4, 3e-3, 0.35)),
    "b_table_grad": ((2e-5, 1e-3, 1e-3), (2e-5, 1e-3, 1e-3)),
    "d_sr_slots": ((1e-6, 1e-6, 2e-4), (1e-6, 1e-6, 2e-4)),
    "e_bf16_wgrad": ((3e-3, 0.1, 0.6), (3e-3, 0.1, 0.6)),
}
ALL = [(mesh, case) for mesh, cases in CASES.items() for case in cases]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {mesh: dense_ranks(mesh, tmp_path_factory.mktemp("ranks"), cases, single=True)
            for mesh, cases in CASES.items()}


def _gaps(losses, want_losses, params, want, start):
    rel = update_rel_l2(params, want, start)
    return (float(np.max(np.abs(losses - want_losses) / np.abs(want_losses))),
            max(v for k, v in rel.items() if k in TABLE_LEAVES), max(rel.values()))


@pytest.mark.parametrize("mesh,case", ALL, ids=[c[0] for _, c in ALL])
def test_sharded_deviation_within_its_measured_size(ranks, mesh, case):
    got = ranks[mesh][case[0]]
    start = flat_numpy(port_init(*case[1:4]))
    losses, params = rectpu_dense_steps(case, mesh)
    single_losses, single = rectpu_dense_steps(case, None)
    sharded = _gaps(got["losses"], losses, got["params"], params, start)
    alone = _gaps(got["single_losses"], single_losses, got["single"], single, start)
    bound_sh, bound_1 = BOUNDS[case[0]]
    for what, g, b in zip(("loss", "table update", "largest leaf update"), sharded, bound_sh):
        assert g <= b, (case[0], "sharded", what, g, b)
    for what, g, b in zip(("loss", "table update", "largest leaf update"), alone, bound_1):
        assert g <= b, (case[0], "single", what, g, b)
    if case[0] == "d_sr_slots":  # repaired: the sharded table update is the single one's
        assert sharded[1] <= alone[1], (sharded, alone)
    if case[0] == "a_flat_cast":  # the port's sharded forward is its single forward
        assert abs(got["losses"][0] - got["single_losses"][0]) <= 1e-6 * got["single_losses"][0]
