"""The port's flat exchanges with the ``scatter_impl="mxu"`` backward
against rectpu's on a 2x2 mesh: the 2d exchange (cotangents all_gathered
back) and the 1d one (whose psum transposes to the identity here, to a psum
of partial shares in rectpu's unchecked shard_map; both give one table
gradient). Split from ``tests/test_torch_parallel.py`` (whose docstring
states the tolerances) because rectpu's mxu backward runs its Pallas scatter
in interpret mode, ~20 s a call on the CPU."""

import pytest

from torch_ep_checks import check_against_rectpu
from torch_mp_worker import run_ranks

NAMES = ("2d_flat_lin1_mxu", "1d_flat_lin1_mxu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return (2, 2), run_ranks("lookups", 4, tmp_path_factory.mktemp("ranks"), num_data=2,
                             num_model=2, names=NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_mxu_backward_matches_rectpu(ranks, name):
    check_against_rectpu(ranks, name)
