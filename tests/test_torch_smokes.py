"""The JAX package's 20 example smokes, through the port on the card.

The tests of tests/test_examples.py (5), tests/test_examples_round3.py
(13) and tests/test_examples_round4.py (2), each example loaded by
``load_example(name, "cuda")`` (``tests/torch_behaviour.py``; the loader
never puts an example in ``sys.modules``, where the JAX tests import
them by bare name), run at the JAX test's own sizes, time steps and
lengths, with its mid-run calls, and held to its assertions and bounds.
They need an NVIDIA GPU and run for minutes, so they are marked
``cuda`` and ``slow`` (the suite's tier-1 run deselects ``slow``) and
skip without a card. The file imports no JAX; on a machine without it
run it without the suite's conftest:

    python -m pytest --noconftest -q -m "cuda and slow" \\
        tests/test_torch_smokes.py
"""

import time

import numpy as np
import pytest
import torch

import torch_behaviour as tb

pytestmark = [pytest.mark.cuda, pytest.mark.slow]
DEV = "cuda"


@pytest.fixture(autouse=True)
def _need_card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the smokes are card runs")
    t0 = time.perf_counter()
    yield
    print(f"[{request.node.name}] {time.perf_counter() - t0:.1f} s",
          flush=True)


def _finite(pos):
    assert np.isfinite(pos).all()


def _say(**readings):
    """Print a test's readings (the card runs' record)."""
    print(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in readings.items()), flush=True)


# --- tests/test_examples.py --------------------------------------------------

def test_rotating_drum_smoke():
    r = tb.rotating_drum_smoke(DEV)
    assert r["n"] > 16
    pos, vel = r["pos"], r["vel"]
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    rad = np.sqrt(pos[:, 0] ** 2 + pos[:, 2] ** 2)
    assert rad.max() < 0.12, rad.max()
    ly = np.mean(pos[:, 2] * vel[:, 0] - pos[:, 0] * vel[:, 2])
    _say(n=r["n"], max_radius=float(rad.max()), ly=float(ly))
    assert abs(ly) > 1e-7


def test_ball_drop_smoke():
    r = tb.ball_drop_smoke(DEV)
    _say(z0=float(r["z0"]), z1=float(r["z1"]), contacts=len(r["pts"]))
    assert r["z1"] < r["z0"]
    _finite(r["pos"])
    assert r["z1"] > -0.3
    assert r["pts"].shape[1] == 3


def test_wheel_dp_smoke():
    r = tb.wheel_dp_smoke(DEV)
    _say(dx=float(r["dx"]), want=2.0 * 0.05 * 0.8 * 0.05)
    vx = 2.0 * 0.05 * (1 - 0.2)
    np.testing.assert_allclose(r["dx"], vx * 0.05, rtol=0.05)
    _finite(r["pos"])


def test_game_of_life_generations():
    r = tb.game_of_life_generations(DEV)
    counts = r["counts"]
    _say(alive0=r["count0"], alive=counts)
    assert len(set(counts + [r["count0"]])) > 1
    assert all(0 <= c <= 12 * 12 for c in counts)


def test_grc_prep_and_restore(tmp_path):
    r = tb.grc_prep_and_restore(DEV, str(tmp_path))
    _say(n1=r["n1"], n2=r["n2"], max_z0=float(r["max_z0"]),
         max_z1=float(r["max_z1"]))
    assert r["n2"] == r["n1"]
    np.testing.assert_allclose(r["r1"], r["r2"], rtol=1e-6)
    _finite(r["p"])
    assert abs(r["max_z1"] - r["max_z0"]) < 0.02


# --- tests/test_examples_round3.py -------------------------------------------

def test_single_sphere_collide_smoke():
    r = tb.single_sphere_collide_smoke(DEV)
    _say(z0=float(r["z0"]), z1=float(r["z1"]))
    assert r["z1"] < r["z0"]
    assert np.isfinite(r["z1"])


def test_test_pack_smoke():
    r = tb.test_pack_smoke(DEV)
    _say(void_ratio=float(r["e"]))
    _finite(r["pos"])
    assert 0.0 < r["e"] < 500.0


def test_contact_chain_smoke():
    r = tb.contact_chain_smoke(DEV)
    _say(bottom_force=float(r["f"]),
         weight=float(r["mass"] * 9.81 * r["n"]),
         max_xy=float(np.abs(r["pos"][:, :2]).max()))
    assert r["f"] > 0.3 * r["mass"] * 9.81 * r["n"]
    _finite(r["pos"])
    assert np.abs(r["pos"][:, :2]).max() < 0.1


def test_shake_smoke():
    pos = tb.shake_smoke(DEV)["pos"]
    _say(z_min=float(pos[:, 2].min()), z_max=float(pos[:, 2].max()))
    _finite(pos)


def test_sieve_smoke():
    r = tb.sieve_smoke(DEV)
    _say(small=float(r["small"]), large=float(r["large"]))
    assert 0.0 <= r["large"] <= r["small"] + 0.75
    _finite(r["pos"])


def test_plow_smoke():
    r = tb.plow_smoke(DEV)
    _say(blade_x=float(r["x0"]))
    assert r["x0"] > -0.25
    _finite(r["pos"])


def test_hopper_smoke():
    r = tb.hopper_smoke(DEV)
    _say(closed=float(r["closed"]), opened=float(r["opened"]))
    assert r["opened"] >= r["closed"]
    _finite(r["pos"])


def test_repose2d_smoke():
    r = tb.repose2d_smoke(DEV)
    _say(angle=float(r["angle"]))
    assert 0.0 <= r["angle"] < 80.0
    _finite(r["pos"])


def test_ball_drop_2d_smoke():
    r = tb.ball_drop_2d_smoke(DEV)
    _say(z0=float(r["z0"]), z1=float(r["z1"]))
    assert r["z1"] < r["z0"]
    assert r["z1"] > -0.32
    _finite(r["pos"])


def test_wheel_slope_slip_smoke():
    r = tb.wheel_slope_slip_smoke(DEV)
    _say(slip=float(r["slip"]))
    assert np.isfinite(r["slip"])
    _finite(r["pos"])


def test_wheel_dp_simplified_smoke():
    r = tb.wheel_dp_simplified_smoke(DEV)
    _say(contacts=len(r["pts"]))
    assert r["pts"].shape[1] == 3
    _finite(r["pos"])


def test_grc_prep_part2_part3_chain(tmp_path):
    r = tb.grc_prep_part2_part3_chain(DEV, str(tmp_path))
    _say(n_extra=r["n_extra"], n_total=r["n_total"])
    assert r["n_extra"] > 0
    assert r["n_total"] >= 60
    _finite(r["pos"])


def test_flexible_mesh_smoke():
    r = tb.flexible_mesh_smoke(DEV)
    _say(contacts=len(r["pts"]))
    assert r["pts"].shape[1] == 3
    _finite(r["pos"])


# --- tests/test_examples_round4.py -------------------------------------------

def test_cohesion_reduces_spread():
    r = tb.cohesion_reduces_spread(DEV)
    _say(dry=float(r["dry"]), cohesive=float(r["cohesive"]))
    assert np.isfinite(r["dry_pos"]).all()
    assert np.isfinite(r["cohesive_pos"]).all()
    assert r["cohesive"] < r["dry"]


def test_mooring_chain_holds():
    r = tb.mooring_chain_holds(DEV)
    p, n_links = r["p"], r["n_links"]
    _say(max_gap=float(np.linalg.norm(np.diff(p, axis=0), axis=1).max()),
         anchor_dz=float(p[0, 2] - 0.5))
    assert np.isfinite(p).all()
    gaps = np.linalg.norm(np.diff(p, axis=0), axis=1)
    assert gaps.max() < 0.035
    assert abs(p[0, 2] - 0.5) < 1e-4
    assert (np.diff(p[:n_links, 2]) < 0).all()
