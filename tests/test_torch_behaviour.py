"""The JAX package's API and model checks that no other port test
holds, through the port on the card.

A JAX test whose body reaches the package only through its API and
numpy runs itself here, on the port's DEMSolver on device "cuda"
(``torch_behaviour.jax_test_body``: its source bound to the port as the
example loader binds an example's): from tests/test_api_balldrop.py the
ball drop that settles, the clump CSV checkpoint restarted into a fresh
solver, the prescribed family, the ChangeFamilyWhen rule and the mid-run
insertion; from tests/test_api_extras.py the stragglers (their memory
getters count the card's memory, 0 on the CPU) and the two velocity
corrections that run 1,000 steps (seconds on the CPU); from
tests/test_flexmesh_checkpoint.py the flexible-mesh update and the solar
orbit at a quarter period; from tests/test_materials_samplers.py the
material-pair override; and tests/test_stage_timers.py. The others are
written in ``tests/torch_behaviour.py`` at the JAX test's own sizes,
time steps and lengths, and held here to its assertions and bounds: the
bonded pair that oscillates and does not escape and the bond that
breaks at high speed (tests/test_custom_force_models.py; its jnp bond
model written with torch ops), the slim SS table filled on demand by
the query (tests/test_api_extras.py, whose JAX body forces that layout
through its engine's internals), and the oversized bin that changes no
physics (tests/test_adaptive_bin.py, whose JAX body builds its solver
through ``dem_engine_tpu.api``). tests/test_torch_coverage.py
names the port test of every other JAX test. They need an NVIDIA GPU
and run for minutes, so they are marked ``cuda`` and ``slow`` (the
suite's tier-1 run deselects ``slow``) and skip without a card. The file
imports no JAX; on a machine without it run it without the suite's
conftest:

    python -m pytest --noconftest -q -m "cuda and slow" \\
        tests/test_torch_behaviour.py
"""

import time

import numpy as np
import pytest
import torch

import torch_behaviour as tb

pytestmark = [pytest.mark.cuda, pytest.mark.slow]
DEV = "cuda"
R = 0.01


@pytest.fixture(autouse=True)
def _need_card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these are card runs")
    t0 = time.perf_counter()
    yield
    print(f"[{request.node.name}] {time.perf_counter() - t0:.1f} s",
          flush=True)


def _jax_body(file, name, **fixtures):
    tb.jax_test_body(file, name, DEV)(**fixtures)


# --- tests/test_api_balldrop.py ----------------------------------------------

def test_balldrop_settles(tmp_path):
    _jax_body("test_api_balldrop.py", "test_balldrop_settles",
              tmp_path=tmp_path)


def test_checkpoint_roundtrip(tmp_path):
    _jax_body("test_api_balldrop.py", "test_checkpoint_roundtrip",
              tmp_path=tmp_path)


def test_prescribed_motion_family():
    _jax_body("test_api_balldrop.py", "test_prescribed_motion_family")


def test_family_change_when():
    _jax_body("test_api_balldrop.py", "test_family_change_when")


def test_update_clumps_midsim():
    _jax_body("test_api_balldrop.py", "test_update_clumps_midsim")


# --- tests/test_adaptive_bin.py ---------------------------------------------

def test_oversized_bin_simulation_matches_floor():
    r = tb.oversized_bin_simulation(DEV)
    np.testing.assert_allclose(r["pa"], r["pb"], rtol=0, atol=1e-6)


# --- tests/test_api_extras.py ------------------------------------------------

def test_correct_family_lin_vel_additive():
    _jax_body("test_api_extras.py", "test_correct_family_lin_vel_additive")


def test_correct_family_lin_vel_callable_component():
    _jax_body("test_api_extras.py",
              "test_correct_family_lin_vel_callable_component")


def test_round3b_api_stragglers(tmp_path):
    _jax_body("test_api_extras.py", "test_round3b_api_stragglers",
              tmp_path=tmp_path)


def test_slim_fused_tables_drop_query_fields_and_fill_on_demand():
    r = tb.slim_fused_tables_fill_on_demand(DEV)
    assert r["rows0"] == 0 and r["rows1"] == 0
    sa = [b for b in r["info"] if b["kind"] == "SA"]
    assert sa, "spheres must rest on the BC plane"
    fz = float(np.sum(sa[0]["force"][:, 2]))
    weight = 6 * 0.001 * 9.81
    assert abs(fz - weight) / weight < 0.2
    assert r["grown_rows"] == (0, 0)


# --- tests/test_custom_force_models.py ---------------------------------------

def test_bonded_pair_oscillates_not_escapes():
    r = tb.bonded_pair_oscillates_not_escapes(DEV)
    assert r["max_gap"] < 0.5 * 2 * R + 1e-3
    p = r["p"]
    assert p[1, 0] - p[0, 0] < 2 * R + 0.5 * 2 * R


def test_bond_breaks_at_high_speed():
    p = tb.bond_breaks_at_high_speed(DEV)["p"]
    assert p[1, 0] - p[0, 0] > 4 * R


# --- tests/test_flexmesh_checkpoint.py ---------------------------------------

def test_flexible_mesh_update():
    _jax_body("test_flexmesh_checkpoint.py", "test_flexible_mesh_update")


def test_solar_system_orbit():
    _jax_body("test_flexmesh_checkpoint.py", "test_solar_system_orbit")


# --- tests/test_materials_samplers.py ----------------------------------------

def test_material_pair_override():
    _jax_body("test_materials_samplers.py", "test_material_pair_override")


# --- tests/test_stage_timers.py ----------------------------------------------

def test_profile_stage_timings_keys_and_print(capsys):
    _jax_body("test_stage_timers.py",
              "test_profile_stage_timings_keys_and_print", capsys=capsys)
