"""pytest's scheduling of the suite over xdist workers.

Under ``--dist loadfile`` xdist hands out each test file whole to one worker.
On one worker ``tests/test_sharding.py`` outlasts the rest of the suite, so
the scheduler here hands out each of its cases on its own, and first; then
``tests/test_multiprocess.py`` whole; then every other file whole, in xdist's
own order. The file is split here, in the scheduler, and not in the file,
because it is a test of rectpu, which stays as it is. Without pytest-xdist
this file defines nothing.
"""

import os
from collections import OrderedDict
from pathlib import Path

import pytest

# files, relative to this directory, whose cases are handed out one by one,
# before anything else
SPLIT_FILES = ("tests/test_sharding.py",)
# whole files handed out right after them: rectpu's multi-process tests, which
# ended the run when they went out late
FIRST_FILES = ("tests/test_multiprocess.py",)

try:
    from xdist.scheduler import LoadFileScheduling
except ImportError:
    LoadFileScheduling = None


def _node_paths(rootpath, files):
    """``files`` as the path part of pytest's node ids under ``rootpath``."""
    here = Path(__file__).parent
    return frozenset(os.path.relpath(here / f, rootpath).replace(os.sep, "/") for f in files)


if LoadFileScheduling is not None:

    class SpreadFileScheduling(LoadFileScheduling):
        """``--dist loadfile``, but each case of ``SPLIT_FILES`` is a scope of
        its own, and those scopes, then ``FIRST_FILES``, go out before any
        other file. xdist orders its queue by the number of tests in a scope,
        which would start the one-case scopes last."""

        def __init__(self, config, log=None):
            super().__init__(config, log)
            self.split = _node_paths(config.rootpath, SPLIT_FILES)
            self.first = _node_paths(config.rootpath, FIRST_FILES)

        def _split_scope(self, nodeid: str) -> str:
            path = nodeid.split("::", 1)[0]
            return nodeid if path in self.split else path

        def _assign_work_unit(self, node) -> None:
            def rank(unit):
                path = unit[0].split("::", 1)[0]
                return 0 if path in self.split else 1 if path in self.first else 2

            self.workqueue = OrderedDict(sorted(self.workqueue.items(), key=rank))
            super()._assign_work_unit(node)

    @pytest.hookimpl(optionalhook=True)
    def pytest_xdist_make_scheduler(config, log):
        if config.getoption("dist") != "loadfile":
            return None
        return SpreadFileScheduling(config, log)
