"""The port's sharded Trainer steps of every family but DeepFM against
rectpu's sharded Trainer steps on the same mesh: DLRM (exact interaction
products, rectpu's CPU pin), xDeepFM, Wide&Deep, DNN, DCN and AutoInt, under
the 2d exchange on 1x2 and the dedup exchange on 2x2, fp32, dropout off,
three Adam steps at lr 0.01 from the port's seeded init
(``tests/test_torch_ep_steps_rectpu.py`` states the tolerances and why).
DeepFM's cases live in that file; these are split off to keep each file
under a minute."""

import pytest

from torch_ep_checks import check_dense_against_rectpu, dense_ranks

FAMILIES = (("dlrm", "dlrm", {}, {"interaction_impl": "xla"}),
            ("xdeep_fm", "xdeep_fm", {}, {"cin_units": (8, 8)}),
            ("wide_deep", "linear_deep", {}, {}),
            ("dnn", "deep", {}, {}),
            ("dcn", "dcn", {}, {"num_cross_layers": 2}),
            ("autoint", "autoint", {}, {}))
MESH_MODES = {(1, 2): "2d", (2, 2): "dedup"}


def _cases(mode):
    return tuple((f"{name}_{mode}", family, cfg, model_kw, False, mode)
                 for name, family, cfg, model_kw in FAMILIES)


@pytest.fixture(scope="module", params=list(MESH_MODES), ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, tmp_path_factory):
    mesh = request.param
    return mesh, dense_ranks(mesh, tmp_path_factory.mktemp("ranks"), _cases(MESH_MODES[mesh]))


@pytest.mark.parametrize("family", [f[0] for f in FAMILIES])
def test_sharded_step_equals_rectpus_sharded_step(ranks, family):
    mesh, got = ranks
    case = next(c for c in _cases(MESH_MODES[mesh]) if c[0].startswith(family + "_"))
    check_dense_against_rectpu(mesh, got, case)
