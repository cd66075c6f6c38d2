"""The port's dedup exchange against rectpu's on a 2x2 mesh: the
capacity-starved drop set and the int8 wire (``tests/test_sharding.py``,
``tests/test_comm_compress.py``). Split from ``tests/test_torch_parallel.py``
(whose docstring states the tolerances) because each rectpu dedup exchange
compiles for ~10-20 s on the CPU."""

import pytest

from torch_ep_checks import check_against_rectpu, check_compressed
from torch_mp_worker import run_ranks

NAMES = ("dedup_starved", "dedup_int8")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return (2, 2), run_ranks("lookups", 4, tmp_path_factory.mktemp("ranks"), num_data=2,
                             num_model=2, names=NAMES)


def test_starved_dedup_drops_rectpus_lookups(ranks):
    check_against_rectpu(ranks, "dedup_starved")


def test_int8_dedup_matches_rectpu(ranks):
    check_compressed(ranks, "dedup_int8", against_rectpu=True)
