"""More of the port's tensor-parallel towers against rectpu's (the cases of
``tests/test_torch_tp_rectpu.py``, split off to keep each file under a
minute): DeepFM plain and flat on the 2x2 mesh under 2d (both axes span
processes; the flat case with hash dropout 0.1 from rectpu's step seeds),
the DeepFM sparse fast step (packed table) at 1x2 under dedup, its towers
tensor-parallel and its table on the sharded lazy-Adam rows, held against
rectpu's ``make_sparse_step`` under its TP plan, with the same tolerances
(losses rtol 1e-6, parameters atol 1e-4; seen: losses within 1.9e-7,
parameters within 1.1e-5).

bf16 towers (DeepFM, 1x2, 2d): the row-parallel layers sum their fp32
partial products over 'model' and round once, as the unsharded product
rounds. Held to its measured gap (ROADMAP.md queue C, "Sharded numerics"):
against rectpu's TP step the gap is the two packages' single-process gap
(seen on the CPU: losses 1.40e-3, the table's update relative L2 0.0433, the
largest leaf's 0.285, a 16-element bias, on both sides), bounded at twice
the readings as ``tests/test_torch_ep_deviations.py`` bounds them; the
port's TP step against its own single step: losses 1.1e-7, the largest
leaf 1.6e-4 (the table), bounded at 1e-6 and 4e-4.
"""

import numpy as np
import pytest

from torch_ep_checks import (check_tp_against_rectpu, flat_numpy, port_init,
                             rectpu_dense_steps, rectpu_tp_steps, tp_ranks, update_rel_l2)
from torch_mp_worker import TP_CASES, _run_dense, build_model, step_inputs

RUNS = {(2, 2): ("deepfm_2d", "deepfm_flat_2d"), (1, 2): ("deepfm_fast_dedup", "deepfm_2d_bf16")}
TABLE_LEAVES = ("table", "emb", "linear/w")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {mesh: tp_ranks(mesh, tmp_path_factory.mktemp("ranks"), names)
            for mesh, names in RUNS.items()}


@pytest.mark.parametrize("mesh,name", [((2, 2), "deepfm_2d"), ((2, 2), "deepfm_flat_2d"),
                                       ((1, 2), "deepfm_fast_dedup")])
def test_tp_step_equals_rectpus_tp_step(ranks, mesh, name):
    check_tp_against_rectpu(mesh, ranks[mesh], name)


def _gaps(losses, want_losses, params, want, start):
    rel = update_rel_l2(params, want, start)
    return (float(np.max(np.abs(losses - want_losses) / np.abs(want_losses))),
            max(v for k, v in rel.items() if k in TABLE_LEAVES), max(rel.values()))


def test_bf16_row_parallel_rounding_within_its_measured_gap(ranks):
    name = "deepfm_2d_bf16"
    _, family, cfg, model_kw, mode, numeric, _ = TP_CASES[name]
    got = ranks[(1, 2)][name]
    start = flat_numpy(port_init(family, cfg, model_kw, numeric))
    losses, params = rectpu_tp_steps(name, (1, 2))
    single_losses, single = rectpu_dense_steps((name, family, cfg, model_kw, False, mode), None)
    model, init = build_model(family, cfg, model_kw, numeric)
    mine_losses, mine = _run_dense(model, init, step_inputs(numeric=len(numeric)), None)
    sharded = _gaps(got["losses"], losses, got["params"], params, start)
    alone = _gaps(mine_losses, single_losses, mine, single, start)
    for what, g, b in zip(("loss", "table update", "largest leaf update"), sharded,
                          (3e-3, 0.1, 0.6)):
        assert g <= b, ("TP vs rectpu's TP", what, g, b)
    for what, g, b in zip(("loss", "table update", "largest leaf update"), alone,
                          (3e-3, 0.1, 0.6)):
        assert g <= b, ("single vs rectpu's single", what, g, b)
    own = _gaps(got["losses"], mine_losses, got["params"], mine, start)
    assert own[0] <= 1e-6 and own[2] <= 4e-4, ("TP vs the port's single step", own)
