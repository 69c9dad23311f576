"""How tier-1 (``pytest tests/ -n 6 --dist loadfile``) hands its tests to
xdist workers. It lives at the repository's root, apart from
``tests/conftest.py`` (the JAX CPU mesh), and imports nothing of the
project.
"""

import os

import pytest

#: Files that ``--dist loadfile`` hands out one test a unit, in this order
#: and ahead of every other file. Their tests run JAX scenes from
#: ``examples/`` and share no fixture. Measured on their worker in a 6-worker
#: run of the suite on 8 CPU cores (5,551 s of work in all): literature
#: 1,234 s (drawbar pull 986 s), demos 786 s (mixer 466 s), round-3 examples
#: 1,176 s (hopper 298 s). Whole and queued last as files of few tests, they
#: ran the suite past its 1,470 s limit. Split, the unit xdist queues behind
#: drawbar pull is one test, so a run cut by its limit loses two tests, not
#: a whole file. A file whose own work passes ~400 s belongs here, not under
#: ``slow``.
LONG_FILES = ("tests/test_validation_literature.py",
              "tests/test_validation_demos.py",
              "tests/test_examples_round3.py")


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """``--dist loadfile`` with each test of LONG_FILES its own unit, handed
    out first. xdist gives each worker two units at the start (a worker
    starts a test only once it knows its next one); with at least twice as
    many split tests as workers both are split tests, so no file waits
    behind the long tests that start first."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongFirst(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            return nodeid if path in LONG_FILES else path

        def _assign_work_unit(self, node):
            split = sorted((s for s in self.workqueue if "::" in s),
                           key=lambda s: LONG_FILES.index(s.split("::")[0]))
            for scope in reversed(split):
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return LongFirst(config, log)


def pytest_runtest_setup(item):
    """An xdist worker moves to nice 10, every thread of it (Linux keeps a
    nice value a thread), from its first test outside the first of
    LONG_FILES, so drawbar pull keeps its cores. In whole runs in turn on
    8 cores it took 846-901 s with every other test at nice 10, 965-1,053 s
    with none, and 993-1,055 s with the demos and round-3 tests at nice 0."""
    if (not hasattr(item.config, "workerinput")
            or item.nodeid.split("::", 1)[0] == LONG_FILES[0]
            or not os.path.isdir("/proc/self/task")):
        return
    for tid in map(int, os.listdir("/proc/self/task")):
        try:
            os.setpriority(os.PRIO_PROCESS, tid,
                           max(10, os.getpriority(os.PRIO_PROCESS, tid)))
        except ProcessLookupError:  # the thread has ended
            pass
