"""The xdist scheduler of the repo root's ``conftest.py``: under
``--dist loadfile`` each case of ``tests/test_sharding.py`` is a work unit of
its own and goes out first, then ``tests/test_multiprocess.py`` as one unit,
then every other file whole, in xdist's own order. Driven with a stub config
and stub workers."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
# loaded under a name of its own: ``conftest`` is this directory's conftest
_spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(root_conftest)
SpreadFileScheduling = root_conftest.SpreadFileScheduling
pytest_xdist_make_scheduler = root_conftest.pytest_xdist_make_scheduler

SHARDING = [f"tests/test_sharding.py::test_ep_flat_grad_mxu_matches_xla[{i}]" for i in range(3)]
MULTIPROCESS = ["tests/test_multiprocess.py::test_a", "tests/test_multiprocess.py::test_b"]
BIG = [f"tests/test_big.py::test_{i}" for i in range(5)]
SMALL = ["tests/test_small.py::test_only"]


def _config(dist="loadfile", workers=2, rootpath=ROOT):
    option = SimpleNamespace(dist=dist, tx=[f"{workers}*popen"], loadscopereorder=True)
    return SimpleNamespace(option=option, rootpath=rootpath,
                           getoption=lambda name: getattr(option, name),
                           getvalue=lambda name: getattr(option, name))


class _Worker:
    """Records, in one list shared by all workers, each batch of node ids it
    is sent, and holds their indices in ``pending`` until they are run."""

    def __init__(self, name, sent, collection):
        self.gateway = SimpleNamespace(id=name)
        self.sent, self.collection = sent, collection
        self.shutting_down = False
        self.pending = []

    def send_runtest_some(self, indices):
        self.sent.append([self.collection[i] for i in indices])
        self.pending.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def _handed_out(collection, workers=2):
    """The batches of node ids in the order the scheduler hands them out,
    with every worker finishing all it holds before the next one does."""
    sched = pytest_xdist_make_scheduler(config=_config(workers=workers), log=None)
    sent = []
    nodes = [_Worker(f"gw{i}", sent, collection) for i in range(workers)]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    for _ in collection:  # each round runs at least one test
        if sched.tests_finished:
            break
        for node in nodes:
            held, node.pending = node.pending, []
            for index in held:
                sched.mark_test_complete(node, index)
    assert sched.tests_finished
    return sent


def test_split_file_cases_are_scopes_of_their_own():
    sched = SpreadFileScheduling(_config())
    assert sched._split_scope(SHARDING[0]) == SHARDING[0]
    assert sched._split_scope(SHARDING[0]) != sched._split_scope(SHARDING[1])


def test_split_follows_the_rootdir():
    """Node ids are relative to pytest's rootdir; with ``tests/`` as the
    rootdir the same file is split under its shorter id."""
    sched = SpreadFileScheduling(_config(rootpath=ROOT / "tests"))
    case = SHARDING[0].removeprefix("tests/")
    assert sched._split_scope(case) == case
    assert sched._split_scope("test_big.py::test_0") == "test_big.py"


def test_other_files_stay_whole():
    sched = SpreadFileScheduling(_config())
    assert {sched._split_scope(nodeid) for nodeid in BIG} == {"tests/test_big.py"}
    assert sched._split_scope(MULTIPROCESS[1]) == "tests/test_multiprocess.py"


def test_split_cases_go_out_first_then_multiprocess():
    sent = _handed_out(BIG + SMALL + MULTIPROCESS + SHARDING)
    assert sent == [[SHARDING[0]], [SHARDING[1]], [SHARDING[2]], MULTIPROCESS, BIG, SMALL]


def test_every_test_is_handed_out_once():
    collection = SHARDING + BIG + MULTIPROCESS + SMALL
    sent = _handed_out(collection, workers=3)
    assert sorted(nodeid for batch in sent for nodeid in batch) == sorted(collection)


def test_other_dist_modes_keep_xdist_scheduler():
    for dist in ("load", "loadscope", "worksteal", "no"):
        assert pytest_xdist_make_scheduler(config=_config(dist=dist), log=None) is None
    assert isinstance(pytest_xdist_make_scheduler(config=_config(), log=None),
                      SpreadFileScheduling)
