"""The suite's xdist scheduler (``pytest_xdist_make_scheduler`` in the
root ``conftest.py``) over a made-up collection: the tests of
``LONG_FILES`` go out first, one a unit and in the tuple's order; every
other file stays one unit. The nodes and the config are stand-ins holding
only what xdist's ``LoadFileScheduling`` reads. Then the workers' nice
values (``pytest_runtest_setup``).
"""

import importlib.util
import os
import pathlib
import types

import pytest

# loaded by path: ``import conftest`` finds tests/conftest.py
_spec = importlib.util.spec_from_file_location(
    "root_conftest", pathlib.Path(__file__).parents[1] / "conftest.py")
conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conftest)

pytest.importorskip("xdist")

FIRST, SECOND = conftest.LONG_FILES[:2]
LONG = [f"{FIRST}::test_{n}" for n in ("repose", "ball_drop", "drawbar")]
NEXT = [f"{SECOND}::test_{n}" for n in "abc"]
BIG = [f"tests/test_big.py::test_{i}" for i in range(6)]
SMALL = ["tests/test_small.py::test_a", "tests/test_small.py::test_b"]
ONE = ["tests/test_one.py::test_only"]
# the second long file collects first, as tests/test_validation_demos.py does
COLLECTION = BIG + ONE + SMALL + NEXT + LONG


class Config:
    option = types.SimpleNamespace(loadscopereorder=True)

    def __init__(self, dist, nodes):
        self.values = {"dist": dist, "tx": [f"{nodes}*popen"]}

    def getvalue(self, name):
        return self.values[name]


class Node:
    shutting_down = False

    def __init__(self, i):
        self.gateway = types.SimpleNamespace(id=f"gw{i}")
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.append([COLLECTION[i] for i in indices])

    def shutdown(self):
        self.shutting_down = True


def scheduled(n_nodes=3):
    sched = conftest.pytest_xdist_make_scheduler(
        config=Config("loadfile", n_nodes), log=None)
    nodes = [Node(i) for i in range(n_nodes)]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, COLLECTION)
    sched.schedule()
    return sched, nodes


def test_each_test_in_one_unit_long_files_split():
    sched, _ = scheduled()
    got = {s: list(u) for s, u in sched.workqueue.items()}
    for workload in sched.assigned_work.values():
        got.update({s: list(u) for s, u in workload.items()})
    assert sorted(i for unit in got.values() for i in unit) == sorted(
        COLLECTION)
    assert got == {**{i: [i] for i in LONG + NEXT},
                   "tests/test_big.py": BIG, "tests/test_small.py": SMALL,
                   "tests/test_one.py": ONE}


def test_long_tests_go_first_in_tuple_order():
    sched, nodes = scheduled()
    # one long test a node, then the next file's tests as the second unit
    # each worker needs before it starts its first test
    assert [n.sent for n in nodes] == [[[a], [b]] for a, b in zip(LONG, NEXT)]
    assert list(sched.workqueue) == ["tests/test_big.py",
                                     "tests/test_small.py",
                                     "tests/test_one.py"]


@pytest.mark.parametrize("n_nodes", [1, 3, 6, 12])
def test_every_worker_knows_a_next_test(n_nodes):
    """An xdist worker runs a test only once it holds the next one or is
    shutting down; a scheduler that left a worker one test would hang."""
    sched, nodes = scheduled(n_nodes)
    for node in nodes:
        held = sum(len(u) for u in sched.assigned_work.get(node, {}).values())
        assert node.shutting_down or held >= 2, (node.gateway.id, held)


def test_worker_takes_work_as_its_tests_end():
    sched, nodes = scheduled()
    sched.mark_test_complete(nodes[2], COLLECTION.index(LONG[2]))
    assert nodes[2].sent[2:] == [BIG]
    sched.mark_test_complete(nodes[0], COLLECTION.index(LONG[0]))
    assert nodes[0].sent[2:] == [SMALL]


def test_other_dist_modes_keep_xdist_default():
    assert conftest.pytest_xdist_make_scheduler(
        config=Config("load", 4), log=None) is None


def nice_values():
    values = set()
    for tid in os.listdir("/proc/self/task"):
        try:
            values.add(os.getpriority(os.PRIO_PROCESS, int(tid)))
        except ProcessLookupError:
            pass
    return values


def test_first_long_file_keeps_its_priority(request):
    before = nice_values()
    worker = types.SimpleNamespace(workerinput={})
    conftest.pytest_runtest_setup(
        types.SimpleNamespace(config=worker, nodeid=LONG[2]))
    assert nice_values() == before
    if hasattr(request.config, "workerinput"):  # this test ran the hook
        assert min(nice_values()) >= 10
