"""Scan dispatch under a ParallelPlan (``train/dispatch.py``): what a
piecewise capture of a sharded step depends on, on the CPU in Gloo ranks
(``tests/torch_mp_worker.py``).

On the card ``StepGraph`` captures a step under a plan as segment graphs
cut at its collectives and replays them with each collective run eagerly
between them, on the buffers its capture recorded. A replay is right only
if every step issues the same collectives in the same order, with the same
shapes and dtypes, on every rank. Here ``dispatch.CollectiveLog`` records
them, with no graph, for DeepFM K=4 [16, 16] (hash dropout 0.1, Adam 0.01)
at 1x2 and 2x2 under the 1d, 2d and dedup exchanges, the sparse fast step
under dedup and the tensor-parallel towers (``--tp-mlp``) under 2d and 1d:

  - each step's sequence is the first step's, on every rank, and holds the
    exchange's or the towers' collectives and a gradient sum;
  - the recorded steps train bit for bit as the same steps unrecorded;
  - every ``raw_*`` collective, with no controller, equals the
    ``torch.distributed`` call it stands for, bit for bit, in fp32, bf16
    and int32, on a 3-D and a transposed input, leaves its input as it was,
    and gives the same bits under the log.
"""

import numpy as np
import pytest

from rectpu_torch.parallel.collectives import OPS
from torch_mp_worker import RECORD_CASES, run_ranks

MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def recorded(request, tmp_path_factory):
    d, m = request.param
    return request.param, run_ranks("record", d * m, tmp_path_factory.mktemp("record"),
                                    num_data=d, num_model=m)


@pytest.mark.parametrize("name", list(RECORD_CASES))
def test_every_step_issues_one_sequence_of_collectives(recorded, name):
    _, ranks = recorded
    first = ranks[0][name]["calls"][0]
    assert {call[0] for call in first} <= set(OPS)
    # the exchange or the towers over 'model', the dense gradients' sum
    assert {call[1] for call in first} & {"model", "world"}, first
    assert any(call[0] == "psum" for call in first), first
    for r, rank in enumerate(ranks):
        for i, calls in enumerate(rank[name]["calls"]):
            assert calls == first, (f"rank {r} step {i}", calls, first)


@pytest.mark.parametrize("name", list(RECORD_CASES))
def test_recorded_steps_train_as_unrecorded_ones(recorded, name):
    _, ranks = recorded
    for rank in ranks:
        got = rank[name]
        np.testing.assert_array_equal(got["losses"], got["plain_losses"])
        assert np.all(np.isfinite(got["losses"]))
        assert got["params"].keys() == got["plain_params"].keys()
        for key, want in got["plain_params"].items():
            np.testing.assert_array_equal(got["params"][key], want, err_msg=key)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return run_ranks("raw_collectives", 2, tmp_path_factory.mktemp("raw"))


@pytest.mark.parametrize("op", OPS)
def test_raw_collectives_unchanged_outside_a_capture(raw, op):
    for rank in raw:
        cases = {tag: v for (o, tag), v in rank.items() if o == op}
        assert len(cases) == 5
        for tag, v in cases.items():
            np.testing.assert_array_equal(v["got"], v["want"], err_msg=tag)
            np.testing.assert_array_equal(v["logged"], v["got"], err_msg=tag)
            assert v["input_kept"], tag
            assert len(v["calls"]) == 1 and v["calls"][0][0] == op, v["calls"]
            assert v["calls"][0][1] == "model"
    f32, i32 = raw[0][(op, "f32")], raw[0][(op, "i32")]
    assert f32["dtype"] == "torch.float32" and i32["dtype"] == "torch.int32"
    assert raw[0][(op, "bf16")]["dtype"] == "torch.bfloat16"
