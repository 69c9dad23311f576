"""The JAX package's DEMSolver-level tests run on the port, on the CPU.

Most tests of tests/test_api_extras.py (and the lost-contact sentry of
tests/test_sentry_and_st.py) reach the package only through its API and
numpy. Their own bodies run here on the port's DEMSolver on the CPU
(``torch_behaviour.jax_test_body``: the source with ``import
dem_engine_tpu as dem`` bound to the port, as the example loader binds
an example's), unchanged, with the pytest fixtures they ask for. The
rest of those files are written again below, each for a reason given
in its docstring: a jnp callable, or a check of the JAX package's own
table layout, which the port holds for its own layout. ``public
classes`` holds every public class of the JAX package to the port's
methods (it found ``DEMMeshConnected.ComputeMassProperties``,
``WriteWavefront`` and ``Clear`` missing). The API tests that need the
card (the memory getters report 0 on the CPU; the slim table's query
path) or run for seconds here (1,000 or more steps) are in
tests/test_torch_behaviour.py.
"""

import inspect

import numpy as np
import pytest
import torch

import dem_engine_tpu_torch as tdem
import torch_behaviour as tb
from dem_engine_tpu_torch.ops import binning, sweep
from dem_engine_tpu_torch.state import ContactTable

torch.set_num_threads(2)

API_EXTRAS = (
    "test_prescribed_linvel_dictate_false_assigns_then_integrates",
    "test_add_owner_next_step_acc_one_shot",
    "test_change_clump_family_and_purge",
    "test_family_owner_wildcard_and_geometry_wildcards",
    "test_tri_anal_wildcards",
    "test_one_time_persistency_and_remove",
    "test_owner_contact_clumps_and_forces",
    "test_disable_family_output",
    "test_device_inspectors_match_host",
    "test_get_bin_size_reflects_margins",
    "test_write_contact_file_including_potential_pairs",
    "test_round3_api_stragglers",
    "test_set_expand_factor_fixed_margin",
    "test_per_axis_prescriptions_accumulate",
    "test_obj_vn_normals_honored",
    "test_mesh_mass_properties_and_wavefront",
    "test_tracker_plural_and_torque_queries",
    "test_clump_template_csv_and_data_file",
    "test_family_material_reassign_and_duplicate",
    "test_output_formats_roundtrip",
    "test_mesh_output_normals_and_obj",
    "test_prescription_merge_keeps_earlier_axes",
)
BODIES = ([("test_api_extras.py", n) for n in API_EXTRAS]
          + [("test_sentry_and_st.py", "test_lost_contact_sentry_fires")])


@pytest.mark.parametrize("file,name", BODIES,
                         ids=[n[len("test_"):] for _, n in BODIES])
def test_jax_body_on_port(file, name, request):
    fn = tb.jax_test_body(file, name, "cpu")
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


def test_correct_family_quaternion_reseats_base():
    """tests/test_api_extras.py's test, its jnp callable written with
    torch (the callable returns a tensor); the file's own
    ``_simple_solver`` on the port."""
    s, _ = tb.port_test_module("test_api_extras.py",
                               "cpu")["_simple_solver"](n=1)
    ang = 0.3
    dq = np.asarray([np.cos(ang / 2), 0, 0, np.sin(ang / 2)], np.float32)
    s.CorrectFamilyQuaternion(0, lambda t: torch.as_tensor(dq))
    s.Initialize()
    s.DoDynamics(0.01)
    q = s.state.owners.quat.numpy()[0]
    yaw = 2 * np.arctan2(q[3], q[0])
    assert abs(yaw - ang) < 1e-3


def test_resize_keeps_unused_layout_placeholders_empty():
    """tests/test_api_extras.py's check on the port's table layout: a
    non-fused table's fused placeholder (fstat_a, (W, 0)) and a slim
    table's wide ones (statics (0, C), force/torque/cpoint (0, 3), no
    premix) stay empty through grown and shrunk, while the fields each
    layout uses resize."""
    t = ContactTable.empty(128, ("delta_tan_x",), ("E:a",), fused=False)
    for g in (t.grown(256), t.shrunk(64)):
        assert g.fstat_a.numel() == 0
        assert g.statics.shape[1] == g.cap and g.force.shape[0] == g.cap
        assert g.premix["E:a"].shape[0] == g.cap
    t2 = ContactTable.empty(128, ("delta_tan_x",), fused=True)
    assert t2.grown(256).fstat_a.shape[1] == 256
    assert t2.shrunk(64).fstat_a.shape[1] == 64
    for g in (t2.grown(256), t2.shrunk(64)):
        assert g.statics.numel() == 0 and g.force.numel() == 0
        assert g.torque.numel() == 0 and g.cpoint.numel() == 0
        assert g.premix == {}


def test_slim_table_has_no_premix():
    """tests/test_pallas_force.py's check on the port: the SS table of a
    built-in Hertz model is the fused pass's slim table, with no premix
    (the kernel reads the premixed moduli from fstat_a rows 9, 10 and
    13); the SA table, which contact_pass reads, keeps it."""
    cfg, state, params = tdem.build_case(64, device="cpu")
    eng = tdem.Engine(cfg)
    state = eng.refresh(state, params)
    assert state.ss.premix == {} and state.ss.statics.shape[0] == 0
    assert state.ss.fstat_a.shape[1] == state.ss.cap
    assert state.sa.premix and state.sa.fstat_a.shape[1] == 0


def test_build_grid_factor_scales_and_clamps():
    """tests/test_adaptive_bin.py's test on the port's build_grid."""
    domain = torch.tensor([1.0, 1.0, 1.0])
    bs1, nb1 = binning.build_grid(domain, torch.tensor(0.01))
    bs2, nb2 = binning.build_grid(domain, torch.tensor(0.01),
                                  torch.tensor(2.0))
    assert float(bs2) == pytest.approx(2.0 * float(bs1), rel=1e-6)
    assert int(nb2[0]) <= -(-int(nb1[0]) // 2) + 1
    bs3, _ = binning.build_grid(domain, torch.tensor(0.01),
                                torch.tensor(0.25))
    assert float(bs3) == pytest.approx(float(bs1), rel=1e-6)


def test_pairs_identical_across_factors():
    """tests/test_adaptive_bin.py's test on the port's search: bigger
    cells change occupancy, never coverage."""
    rng = np.random.default_rng(7)
    n = 400
    pos = torch.from_numpy(rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32))
    reach = torch.full((n,), 0.02)
    owner = torch.arange(n, dtype=torch.int32)
    family = torch.zeros(n, dtype=torch.int32)
    mask = torch.ones((256, 256), dtype=torch.bool)
    domain = torch.tensor([1.0, 1.0, 1.0])

    def pairs(factor):
        bs, nb = binning.build_grid(domain, reach.max(),
                                    torch.tensor(factor))
        a, b, cnt, _ = sweep.find_pairs_ss(pos, reach, owner, family, mask,
                                           bs, nb, 65536)
        live = a >= 0
        return set(zip(a[live].tolist(), b[live].tolist()))

    p1 = pairs(1.0)
    assert p1 and p1 == pairs(1.7) and p1 == pairs(3.0)


def test_adaptive_flag_reaches_engine():
    """tests/test_adaptive_bin.py's test on the port."""
    sim = tb.adaptive_bin_sim("cpu")
    sim.UseAdaptiveBinSize(True)
    sim.Initialize()
    assert sim.engine.auto_bin
    sim.UseAdaptiveBinSize(False)
    assert not sim.engine.auto_bin


def test_public_classes_match_jax():
    """Every public class of the JAX package's top level has each of its
    public methods on the port's class of that name."""
    import dem_engine_tpu as jdem

    missing = {}
    for name in dir(jdem):
        a = getattr(jdem, name)
        if name.startswith("_") or not inspect.isclass(a):
            continue
        b = getattr(tdem, name)
        gone = {m for m in dir(a) if not m.startswith("_")} - set(dir(b))
        if gone:
            missing[name] = sorted(gone)
    assert not missing, missing
