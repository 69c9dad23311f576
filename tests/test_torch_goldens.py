"""The JAX package's engine goldens, through the port on the card.

The 10 tests of tests/test_engine_two_spheres.py,
tests/test_engine_friction_settle.py and tests/test_engine_clumps_mesh.py
(head-on restitution, the elastic rebound, no motion without contact,
the plane bounce, slide-to-roll at 5/7 v0, the settling bed, the
dumbbell settling flat, clump-collision momentum and the mesh bounce),
each built by ``tests/torch_behaviour.py`` through the port's
``initializer``, ``SolverConfig`` and ``Engine.advance`` on device
"cuda", at the JAX test's own sizes, time steps and lengths, and held to
its bounds (``torch_behaviour.GOLDENS``). ``chip_smoke.py --phases
goldens`` runs the same bodies. They need an NVIDIA GPU and run for
minutes, so they are marked ``cuda`` and ``slow`` (the suite's tier-1
run deselects ``slow``) and skip without a card. The file imports no
JAX; on a machine without it run it without the suite's conftest:

    python -m pytest --noconftest -q -m "cuda and slow" \\
        tests/test_torch_goldens.py
"""

import time

import pytest
import torch

import torch_behaviour as tb

pytestmark = [pytest.mark.cuda, pytest.mark.slow]
DEV = "cuda"

GOLDENS = {g.name: g for g in tb.GOLDENS}


@pytest.fixture(autouse=True)
def _need_card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the goldens are card runs")
    t0 = time.perf_counter()
    yield
    print(f"[{request.node.name}] {time.perf_counter() - t0:.1f} s",
          flush=True)


def _golden(name):
    g = GOLDENS[name]
    r = g.run(DEV)
    print(f"{name}: {g.reading(r)}; {r['steps']} steps, "
          f"{r['seconds'] / r['steps'] * 1e3:.3f} ms/step")
    g.check(r)


# --- tests/test_engine_two_spheres.py ----------------------------------------

def test_head_on_restitution():
    _golden("head_on_restitution")


def test_head_on_frictionless_model():
    _golden("head_on_frictionless_model")


def test_no_contact_no_motion():
    _golden("no_contact_no_motion")


def test_plane_bounce_restitution():
    _golden("plane_bounce_restitution")


def test_head_on_restitution_segment_reduce():
    _golden("head_on_restitution_segment_reduce")


# --- tests/test_engine_friction_settle.py ------------------------------------

def test_slide_to_roll():
    _golden("slide_to_roll")


def test_settling_bed():
    _golden("settling_bed")


# --- tests/test_engine_clumps_mesh.py ----------------------------------------

def test_dumbbell_settles_flat():
    _golden("dumbbell_settles_flat")


def test_clump_collision_momentum():
    _golden("clump_collision_momentum")


def test_mesh_bounce_restitution():
    _golden("mesh_bounce_restitution")
