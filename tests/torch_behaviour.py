"""The JAX package's behaviour tests as bodies that run on the port.

One function per ported JAX test: it builds the test's scene on a given
device at the test's own sizes, time steps and lengths, runs it and
returns its readings (a dict). The card test files
(``tests/test_torch_goldens.py``, ``test_torch_smokes.py``,
``test_torch_behaviour.py``) assert on them with the JAX tests' bounds,
and ``chip_smoke.py``'s goldens phase runs the engine goldens through
``GOLDENS`` with the same checks, so the card runs exactly what the
tests assert. Not a test module itself: it imports no JAX, so
``chip_smoke.py`` imports it on a machine without JAX.

* The engine goldens (``tests/test_engine_two_spheres.py``,
  ``test_engine_friction_settle.py``, ``test_engine_clumps_mesh.py``)
  through ``initializer.make_*``, ``SolverConfig`` and
  ``Engine(cfg).advance``. Their checks are here (``check_*``), since the
  test file and ``chip_smoke.py`` both hold them.
* The 20 example smokes (``tests/test_examples*.py``), each example
  through ``load_example(name, device)``.
* The API and model checks that no other port test holds
  (``tests/test_torch_coverage.py`` names the port test of every JAX
  test): a JAX test body that reaches the package only through its API
  and numpy runs itself on the port (``jax_test_body``); the others are
  written here on ``examples.device_view(device)`` (the port's names
  with a ``DEMSolver`` on `device`), a jnp force model with torch ops.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable

import numpy as np
import torch

from dem_engine_tpu_torch.defines import ANAL_PLANE, TimeIntegrator
from dem_engine_tpu_torch.examples import device_view, load_example
from dem_engine_tpu_torch.initializer import (
    concat_owners,
    make_analyticals,
    make_owners,
    make_params,
    make_spheres,
    make_state,
    make_triangles,
)
from dem_engine_tpu_torch.models import (
    HertzianForceModel,
    HertzianFrictionlessForceModel,
)
from dem_engine_tpu_torch.solver import Engine
from dem_engine_tpu_torch.state import SolverConfig

NU = 0.3
RHO = 2500.0
R = 0.01
VOXEL = 1.0 / 2**16


def _np(x):
    return x.detach().cpu().numpy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def decode(state, voxel_size=VOXEL):
    """Owner positions, float64 on the host (the JAX tests'
    ``voxel.decode_host``)."""
    from dem_engine_tpu_torch.ops import voxel

    return voxel.decode_host(_np(state.owners.vox), _np(state.owners.loc),
                             voxel_size)


def advance(eng, state, params, n_steps, k, out):
    """``eng.advance`` with its steps and synchronised seconds added to
    `out` (the readings' "steps" and "seconds"; "k" the CD cadence)."""
    _sync(state.device)
    t0 = time.perf_counter()
    state = eng.advance(state, params, n_steps, update_freq=k)
    _sync(state.device)
    out["k"] = k
    out["steps"] = out.get("steps", 0) + n_steps
    out["seconds"] = out.get("seconds", 0.0) + time.perf_counter() - t0
    return state


# --- the engine goldens ------------------------------------------------------

def _materials(E=1e9, cor=0.9, mu=0.3, crr=0.0):
    return (
        {"E": np.asarray([E], np.float32), "nu": np.asarray([NU], np.float32)},
        {"CoR": np.asarray([[cor]], np.float32),
         "mu": np.asarray([[mu]], np.float32),
         "Crr": np.asarray([[crr]], np.float32)},
    )


def _cfg(model=None, cap_ss=64, cap_sa=64, cap_st=64):
    return SolverConfig(
        voxel_size=VOXEL, integrator=TimeIntegrator.CENTERED_DIFFERENCE,
        force_model=model or HertzianForceModel(), cap_ss=cap_ss,
        cap_sa=cap_sa, cap_st=cap_st)


def _sphere_mass():
    mass = RHO * 4 / 3 * np.pi * R**3
    return mass, 2 / 5 * mass * R**2


def _fixed_owner(pos, device):
    """The plane's or the platform's owner: family 255, mass 1e30."""
    return make_owners(pos=np.asarray([pos]), voxel_size=VOXEL, family=[255],
                       mass=[1e30], moi=np.full((1, 3), 1e30), device=device)


def _plane(owner, device):
    return make_analyticals(
        owner=[owner], objtype=[ANAL_PLANE], relpos=np.zeros((1, 3)),
        direction=[[0.0, 0.0, 1.0]], size=np.zeros((1, 3)),
        normal_sign=[1.0], device=device)


def two_sphere_setup(device, v0=1.0, cor=0.9, model=None, h=1e-6, E=1e9):
    """tests/test_engine_two_spheres.py's ``_two_sphere_setup``: two
    spheres 2.5 R apart closing at v0 each, cap_ss 16, no gravity.
    Returns (engine, state, params, mass)."""
    cfg = _cfg(model, cap_ss=16, cap_sa=8, cap_st=8)
    mass, moi = _sphere_mass()
    gap = 2.5 * R
    owners = make_owners(
        pos=np.asarray([[0.5 - gap / 2, 0.5, 0.5], [0.5 + gap / 2, 0.5, 0.5]]),
        voxel_size=VOXEL, vel=np.asarray([[v0, 0, 0], [-v0, 0, 0]]),
        mass=np.full(2, mass), moi=np.full((2, 3), moi), device=device)
    spheres = make_spheres(owner=[0, 1], relpos=np.zeros((2, 3)),
                           radius=np.full(2, R), device=device)
    state = make_state(owners, spheres, cfg)
    mats, pairs = _materials(E=E, cor=cor)
    params = make_params(h=h, gravity=[0, 0, 0], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs,
                         update_freq=50, device=device)
    return Engine(cfg), state, params, mass


def head_on_restitution(device):
    cor = 0.8
    eng, state, params, _ = two_sphere_setup(device, v0=1.0, cor=cor)
    out = dict(cor=cor)
    state = advance(eng, state, params, 5000, 50, out)
    out["v"] = _np(state.owners.vel)
    return out


def check_head_on_restitution(r):
    v, cor = r["v"], r["cor"]
    assert v[0, 0] < 0 and v[1, 0] > 0, f"spheres must rebound, got {v}"
    np.testing.assert_allclose(abs(v[0, 0]), cor, rtol=0.05)
    np.testing.assert_allclose(abs(v[1, 0]), cor, rtol=0.05)
    np.testing.assert_allclose(v[0] + v[1], 0.0, atol=1e-5)


def head_on_frictionless_model(device):
    eng, state, params, _ = two_sphere_setup(
        device, v0=1.0, cor=1.0, model=HertzianFrictionlessForceModel())
    out = {}
    state = advance(eng, state, params, 5000, 50, out)
    out["v"] = _np(state.owners.vel)
    return out


def check_head_on_frictionless_model(r):
    np.testing.assert_allclose(abs(r["v"][0, 0]), 1.0, rtol=0.03)


def no_contact_no_motion(device):
    eng, state, params, _ = two_sphere_setup(device, v0=0.0)
    out = {}
    state = advance(eng, state, params, 100, 20, out)
    out["v"] = _np(state.owners.vel)
    return out


def check_no_contact_no_motion(r):
    np.testing.assert_allclose(r["v"], 0.0, atol=1e-12)


def plane_bounce_restitution(device):
    """tests/test_engine_two_spheres.py::test_plane_bounce_restitution:
    a sphere dropped 5 mm onto a plane, 1.5 times its fall time."""
    cor, h, drop_h, z_plane = 0.7, 2e-6, 0.005, 0.1
    cfg = _cfg(cap_ss=8, cap_sa=8, cap_st=8)
    mass, moi = _sphere_mass()
    owners = concat_owners(
        make_owners(pos=np.asarray([[0.5, 0.5, z_plane + R + drop_h]]),
                    voxel_size=VOXEL, mass=[mass], moi=np.full((1, 3), moi),
                    device=device),
        _fixed_owner([0.5, 0.5, z_plane], device))
    spheres = make_spheres(owner=[0], relpos=np.zeros((1, 3)), radius=[R],
                           device=device)
    state = make_state(owners, spheres, cfg, anals=_plane(1, device))
    mats, pairs = _materials(E=1e9, cor=cor, mu=0.0)
    params = make_params(h=h, gravity=[0, 0, -9.81], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs, device=device)
    eng = Engine(cfg)
    t_fall = np.sqrt(2 * drop_h / 9.81)
    out = dict(v_impact=np.sqrt(2 * 9.81 * drop_h), cor=cor,
               z_rest=z_plane + R)
    state = advance(eng, state, params, int((t_fall * 1.5) / h), 40, out)
    out["v"] = _np(state.owners.vel)
    out["z_end"] = decode(state)[0, 2]
    return out


def _bounce(r):
    """Rebound speed off the surface from the end state: 0.5 v_b^2 =
    0.5 v_end^2 + g dz."""
    vz = r["v"][0, 2]
    return np.sqrt(vz**2 + 2 * 9.81 * (r["z_end"] - r["z_rest"]))


def check_plane_bounce_restitution(r):
    assert r["v"][0, 2] > 0, f"sphere must have bounced, vz={r['v'][0, 2]}"
    np.testing.assert_allclose(_bounce(r), r["cor"] * r["v_impact"],
                               rtol=0.1)


def head_on_restitution_segment_reduce(device):
    """test_head_on_restitution_segment_reduce: the JAX test's
    reduce_mode="segment" picks its sorted-segment reduction; the port
    has only that one (kernel A), so the body is head_on_restitution's
    scene built as that test builds it (mu 0.3, CoR 0.8)."""
    return head_on_restitution(device)


def slide_to_roll(device):
    """tests/test_engine_friction_settle.py::test_slide_to_roll."""
    cfg = _cfg(cap_ss=64, cap_sa=64, cap_st=8)
    mass, moi = _sphere_mass()
    z_plane, delta_eq, v0 = 0.1, 1.4e-6, 0.2
    owners = concat_owners(
        make_owners(pos=np.asarray([[0.3, 0.5, z_plane + R - delta_eq]]),
                    voxel_size=VOXEL, vel=np.asarray([[v0, 0, 0]]),
                    mass=[mass], moi=np.full((1, 3), moi), device=device),
        _fixed_owner([0.5, 0.5, z_plane], device))
    spheres = make_spheres(owner=[0], relpos=np.zeros((1, 3)), radius=[R],
                           device=device)
    state = make_state(owners, spheres, cfg, anals=_plane(1, device))
    mats, pairs = _materials(cor=0.3, mu=0.5)
    params = make_params(h=2e-6, gravity=[0, 0, -9.81], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs,
                         update_freq=25, device=device)
    out = dict(v0=v0)
    state = advance(Engine(cfg), state, params, 9000, 25, out)
    out["v"] = float(state.owners.vel[0, 0])
    out["w"] = float(state.owners.omg[0, 1])
    return out


def check_slide_to_roll(r):
    np.testing.assert_allclose(r["v"], 5.0 / 7.0 * r["v0"], rtol=0.05)
    np.testing.assert_allclose(r["w"] * R, r["v"], rtol=0.05)


SETTLE_Z_PLANE = 0.05
SETTLE_NZ = 3


def settling_bed_setup(device):
    """test_settling_bed's 4x4x3 grid on a plane, cap_ss 2048, cap_sa
    1024, h 5e-6, K 20. Returns (engine, state, params, n)."""
    cfg = _cfg(cap_ss=2048, cap_sa=1024, cap_st=8)
    mass, moi = _sphere_mass()
    nx, ny, nz = 4, 4, SETTLE_NZ
    xs = 0.5 + (np.arange(nx) - (nx - 1) / 2) * 2.2 * R
    ys = 0.5 + (np.arange(ny) - (ny - 1) / 2) * 2.2 * R
    zs = SETTLE_Z_PLANE + R * 1.05 + np.arange(nz) * 2.2 * R
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(3)
    g[:, :2] += rng.uniform(-0.1 * R, 0.1 * R, size=(g.shape[0], 2))
    n = g.shape[0]
    owners = concat_owners(
        make_owners(pos=g, voxel_size=VOXEL, mass=np.full(n, mass),
                    moi=np.full((n, 3), moi), device=device),
        _fixed_owner([0.5, 0.5, SETTLE_Z_PLANE], device))
    spheres = make_spheres(owner=np.arange(n), relpos=np.zeros((n, 3)),
                           radius=np.full(n, R), device=device)
    state = make_state(owners, spheres, cfg, anals=_plane(n, device))
    mats, pairs = _materials(cor=0.4, mu=0.4)
    params = make_params(h=5e-6, gravity=[0, 0, -9.81], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs,
                         update_freq=20, device=device)
    return Engine(cfg), state, params, n


def settling_bed(device):
    """The bed after its 12,000 steps; "final" holds (engine, state,
    params), whose tables chip_smoke.py holds the kernels on."""
    eng, state, params, n = settling_bed_setup(device)
    out = dict(n=n)
    state = advance(eng, state, params, 12000, 20, out)
    out["final"] = (eng, state, params)
    out["pos"] = decode(state)[:n]
    out["vel"] = _np(state.owners.vel)[:n]
    out["ss_count"] = int(state.ss.count)
    return out


def check_settling_bed(r):
    pos, vel, n = r["pos"], r["vel"], r["n"]
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert (pos[:, 2] > SETTLE_Z_PLANE + R - 5e-4).all(), pos[:, 2].min()
    assert pos[:, 2].max() < SETTLE_Z_PLANE + (SETTLE_NZ + 1) * 2 * R
    assert np.abs(vel).max() < 0.25, np.abs(vel).max()
    assert r["ss_count"] > n // 2


def _dumbbell_props():
    m_sph = RHO * 4 / 3 * np.pi * R**3
    i_sph = 2 / 5 * m_sph * R**2
    moi = np.asarray([2 * i_sph, 2 * (i_sph + m_sph * R**2),
                      2 * (i_sph + m_sph * R**2)])
    return 2 * m_sph, moi, np.asarray([[-R, 0, 0], [R, 0, 0]])


DUMBBELL_Z_PLANE = 0.1


def dumbbell_settles_flat(device):
    """tests/test_engine_clumps_mesh.py::test_dumbbell_settles_flat."""
    cfg = _cfg()
    mass, moi, rel = _dumbbell_props()
    z_plane = DUMBBELL_Z_PLANE
    owners = concat_owners(
        make_owners(pos=np.asarray([[0.5, 0.5, z_plane + R + 0.002]]),
                    voxel_size=VOXEL, mass=[mass], moi=moi.reshape(1, 3),
                    device=device),
        _fixed_owner([0.5, 0.5, z_plane], device))
    spheres = make_spheres(owner=[0, 0], relpos=rel, radius=[R, R],
                           device=device)
    state = make_state(owners, spheres, cfg, anals=_plane(1, device))
    mats, pairs = _materials(cor=0.3, mu=0.4)
    params = make_params(h=4e-6, gravity=[0, 0, -9.81], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs,
                         update_freq=20, device=device)
    out = {}
    state = advance(Engine(cfg), state, params, 15000, 20, out)
    out["pos"] = decode(state)
    out["vel"] = _np(state.owners.vel)
    out["quat"] = _np(state.owners.quat[0])
    return out


def check_dumbbell_settles_flat(r):
    assert np.abs(r["vel"][0]).max() < 0.05
    np.testing.assert_allclose(r["pos"][0, 2], DUMBBELL_Z_PLANE + R,
                               atol=3e-4)
    assert abs(abs(r["quat"][0]) - 1.0) < 0.05


def clump_collision_momentum(device):
    """tests/test_engine_clumps_mesh.py::test_clump_collision_momentum."""
    cfg = _cfg()
    mass, moi, rel = _dumbbell_props()
    v0 = 1.0
    owners = make_owners(
        pos=np.asarray([[0.47, 0.5, 0.5], [0.53, 0.5 + 0.005, 0.5]]),
        voxel_size=VOXEL, vel=np.asarray([[v0, 0, 0], [-v0, 0, 0]]),
        mass=[mass, mass], moi=np.tile(moi, (2, 1)), device=device)
    spheres = make_spheres(owner=[0, 0, 1, 1],
                           relpos=np.concatenate([rel, rel]),
                           radius=np.full(4, R), device=device)
    state = make_state(owners, spheres, cfg)
    mats, pairs = _materials(cor=0.8, mu=0.2)
    params = make_params(h=1e-6, gravity=[0, 0, 0], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs,
                         update_freq=40, device=device)
    out = dict(mass=mass, moi=moi, v0=v0)
    out["e0"] = float(0.5 * mass * (_np(state.owners.vel) ** 2).sum())
    state = advance(Engine(cfg), state, params, 12000, 40, out)
    out["vel"] = _np(state.owners.vel)
    out["omg"] = _np(state.owners.omg)
    return out


def check_clump_collision_momentum(r):
    vel, omg, mass, moi = r["vel"], r["omg"], r["mass"], r["moi"]
    assert vel[0, 0] < 0 and vel[1, 0] > 0
    np.testing.assert_allclose((vel[0] + vel[1]) * mass, 0.0,
                               atol=1e-4 * mass * r["v0"] * 10)
    e1 = float(0.5 * mass * (vel**2).sum()
               + 0.5 * ((moi[None, :] * omg**2).sum()))
    assert e1 <= r["e0"] * 1.01


def mesh_bounce_setup(device, at_impact=False):
    """test_mesh_bounce_restitution's sphere 4 mm over a 2-triangle
    platform (CoR 0.6, mu 0, h 2e-6, K 30); `at_impact` starts it 0.1
    mm over the platform at the impact speed instead (the ST table's
    contact within a few hundred steps). Returns (engine, state, params,
    readings with the bounce's constants)."""
    cor, z_mesh, drop_h, h = 0.6, 0.1, 0.004, 2e-6
    v_impact = np.sqrt(2 * 9.81 * drop_h)
    cfg = _cfg()
    m_sph, moi = _sphere_mass()
    z0 = z_mesh + R + (1e-4 if at_impact else drop_h)
    owners = concat_owners(
        make_owners(pos=np.asarray([[0.52, 0.48, z0]]), voxel_size=VOXEL,
                    vel=np.asarray([[0, 0, -v_impact if at_impact else 0]]),
                    mass=[m_sph], moi=np.full((1, 3), moi), device=device),
        _fixed_owner([0.5, 0.5, z_mesh], device))
    half = 0.05
    verts = np.asarray([[-half, -half, 0.0], [half, -half, 0.0],
                        [half, half, 0.0], [-half, half, 0.0]])
    faces = np.asarray([[0, 1, 2], [0, 2, 3]])
    tris = make_triangles(owner=[1, 1], nodes=verts[faces], device=device)
    spheres = make_spheres(owner=[0], relpos=np.zeros((1, 3)), radius=[R],
                           device=device)
    state = make_state(owners, spheres, cfg, tris=tris)
    mats, pairs = _materials(cor=cor, mu=0.0)
    params = make_params(h=h, gravity=[0, 0, -9.81], domain=[1, 1, 1],
                         materials=mats, pair_materials=pairs,
                         update_freq=30, device=device)
    t_fall = np.sqrt(2 * drop_h / 9.81)
    consts = dict(cor=cor, v_impact=v_impact,
                  z_rest=z_mesh + R, n_steps=int(t_fall * 1.5 / h))
    return Engine(cfg), state, params, consts


def mesh_bounce_restitution(device):
    eng, state, params, out = mesh_bounce_setup(device)
    state = advance(eng, state, params, out.pop("n_steps"), 30, out)
    out["v"] = _np(state.owners.vel)
    out["z_end"] = decode(state)[0, 2]
    return out


def check_mesh_bounce_restitution(r):
    assert r["v"][0, 2] > 0, f"must bounce, vz={r['v'][0, 2]}"
    np.testing.assert_allclose(_bounce(r), r["cor"] * r["v_impact"],
                               rtol=0.1)


@dataclasses.dataclass(frozen=True)
class Golden:
    name: str
    jax_test: str       # the JAX test's node id
    run: Callable       # run(device) -> readings
    check: Callable     # check(readings); raises AssertionError
    bound: str          # the JAX test's bounds, for printing
    reading: Callable   # readings -> the numbers printed beside the bound


_TS = "tests/test_engine_two_spheres.py::"
_FS = "tests/test_engine_friction_settle.py::"
_CM = "tests/test_engine_clumps_mesh.py::"

GOLDENS = (
    Golden("head_on_restitution", _TS + "test_head_on_restitution",
           head_on_restitution, check_head_on_restitution,
           "|v| within rtol 0.05 of CoR 0.8, momentum within atol 1e-5",
           lambda r: f"|v| {abs(r['v'][0, 0]):.6f} {abs(r['v'][1, 0]):.6f},"
                     f" momentum {np.abs(r['v'][0] + r['v'][1]).max():.2e}"),
    Golden("head_on_frictionless_model",
           _TS + "test_head_on_frictionless_model",
           head_on_frictionless_model, check_head_on_frictionless_model,
           "|v| within rtol 0.03 of 1.0",
           lambda r: f"|v| {abs(r['v'][0, 0]):.6f}"),
    Golden("no_contact_no_motion", _TS + "test_no_contact_no_motion",
           no_contact_no_motion, check_no_contact_no_motion,
           "every velocity within atol 1e-12 of 0",
           lambda r: f"max |v| {np.abs(r['v']).max():.3e}"),
    Golden("plane_bounce_restitution",
           _TS + "test_plane_bounce_restitution",
           plane_bounce_restitution, check_plane_bounce_restitution,
           "vz > 0, rebound within rtol 0.1 of CoR 0.7 x impact speed",
           lambda r: f"vz {r['v'][0, 2]:.5f}, rebound/impact "
                     f"{_bounce(r) / r['v_impact']:.5f}"),
    Golden("head_on_restitution_segment_reduce",
           _TS + "test_head_on_restitution_segment_reduce",
           head_on_restitution_segment_reduce, check_head_on_restitution,
           "|v| within rtol 0.05 of CoR 0.8, momentum within atol 1e-5",
           lambda r: f"|v| {abs(r['v'][0, 0]):.6f} {abs(r['v'][1, 0]):.6f},"
                     f" momentum {np.abs(r['v'][0] + r['v'][1]).max():.2e}"),
    Golden("slide_to_roll", _FS + "test_slide_to_roll",
           slide_to_roll, check_slide_to_roll,
           "v within rtol 0.05 of 5/7 v0 = 0.142857, w R within rtol "
           "0.05 of v",
           lambda r: f"v {r['v']:.6f}, w R {r['w'] * R:.6f}"),
    Golden("settling_bed", _FS + "test_settling_bed",
           settling_bed, check_settling_bed,
           "z > plane + R - 5e-4, top below 4 layers, max |v| < 0.25, "
           "ss.count > n/2 = 24",
           lambda r: f"z {r['pos'][:, 2].min():.5f}..."
                     f"{r['pos'][:, 2].max():.5f}, max |v| "
                     f"{np.abs(r['vel']).max():.4f}, ss.count "
                     f"{r['ss_count']}"),
    Golden("dumbbell_settles_flat", _CM + "test_dumbbell_settles_flat",
           dumbbell_settles_flat, check_dumbbell_settles_flat,
           "max |v| < 0.05, CoM z within atol 3e-4 of plane + R, "
           "||q0| - 1| < 0.05",
           lambda r: f"max |v| {np.abs(r['vel'][0]).max():.5f}, z - "
                     f"(plane + R) {r['pos'][0, 2] - DUMBBELL_Z_PLANE - R:.2e}"
                     f", |q0| {abs(r['quat'][0]):.6f}"),
    Golden("clump_collision_momentum", _CM + "test_clump_collision_momentum",
           clump_collision_momentum, check_clump_collision_momentum,
           "rebound, momentum within atol 1e-3 m v0, energy <= 1.01 e0",
           lambda r: f"vx {r['vel'][0, 0]:.5f} {r['vel'][1, 0]:.5f}, "
                     f"momentum/(m v0) "
                     f"{np.abs(r['vel'][0] + r['vel'][1]).max():.2e}"),
    Golden("mesh_bounce_restitution", _CM + "test_mesh_bounce_restitution",
           mesh_bounce_restitution, check_mesh_bounce_restitution,
           "vz > 0, rebound within rtol 0.1 of CoR 0.6 x impact speed",
           lambda r: f"vz {r['v'][0, 2]:.5f}, rebound/impact "
                     f"{_bounce(r) / r['v_impact']:.5f}"),
)


# --- the example smokes ------------------------------------------------------

def _positions(s, n=None):
    p = np.asarray(s.GetOwnerPosition())
    return p if n is None else p[:n]


def rotating_drum_smoke(device, tmp=None):
    m = load_example("rotating_drum", device)
    solver, batch, n = m.build(n_clumps=48, update_freq=20, h=1e-5)
    solver.DoDynamics(0.15)
    k = solver.GetNumClumps()
    return dict(n=n, pos=solver.GetOwnerPosition()[:k],
                vel=solver.GetOwnerVelocity()[:k])


def ball_drop_smoke(device, tmp=None):
    m = load_example("ball_drop", device)
    solver, tracker, mesh, n = m.build(n_side=3, verbosity="QUIET", h=1e-5)
    z0 = tracker.Pos()[2]
    solver.DoDynamics(0.1)
    pts, fs = tracker.GetContactForces()
    return dict(z0=z0, z1=tracker.Pos()[2], pts=pts,
                pos=solver.GetOwnerPosition()[:solver.GetNumClumps()])


def wheel_dp_smoke(device, tmp=None):
    m = load_example("wheel_dp", device)
    solver, tracker, n = m.build(n_side=4, verbosity="QUIET", h=1e-5)
    x0 = tracker.Pos()[0]
    solver.DoDynamics(0.05)
    return dict(dx=tracker.Pos()[0] - x0,
                pos=solver.GetOwnerPosition()[:solver.GetNumClumps()])


def game_of_life_generations(device, tmp=None):
    m = load_example("game_of_life", device)
    solver, batch, fam0 = m.build(n=12, verbosity="QUIET")
    counts = []
    for _ in range(4):
        solver.DoStepDynamics()
        fam = solver.GetOwnerFamily()[:solver.GetNumClumps()]
        counts.append(int((fam == m.ALIVE).sum()))
    return dict(counts=counts, count0=int((np.asarray(fam0) == m.ALIVE).sum()))


def grc_prep_and_restore(device, tmp):
    m = load_example("grc_prep", device)
    solver, batch, tmpls = m.build(n_clumps=60, verbosity="QUIET")
    solver.DoDynamics(0.06)
    ck = os.path.join(tmp, "terrain.csv")
    solver.WriteClumpFile(ck)
    max_z0 = solver.CreateInspector("clump_max_z").GetValue()
    s2 = m.restore(ck, verbosity="QUIET")
    out = dict(n1=solver.GetNumClumps(), n2=s2.GetNumClumps(),
               r1=np.sort(_np(solver.state.spheres.radius)),
               r2=np.sort(_np(s2.state.spheres.radius)), max_z0=max_z0)
    s2.DoDynamics(0.02)
    out["p"] = s2.GetOwnerPosition()[:s2.GetNumClumps()]
    out["max_z1"] = s2.CreateInspector("clump_max_z").GetValue()
    return out


def single_sphere_collide_smoke(device, tmp=None):
    s = load_example("single_sphere_collide", device).build(h=5e-6)
    z0 = s.GetOwnerPosition()[0, 2]
    s.DoDynamics(0.05)
    return dict(z0=z0, z1=s.GetOwnerPosition()[0, 2])


def test_pack_smoke(device, tmp=None):
    m = load_example("test_pack", device)
    s, n = m.build(n=60, h=4e-5)
    s.DoDynamics(0.12)
    return dict(pos=_positions(s, n), e=m.void_ratio(s))


def contact_chain_smoke(device, tmp=None):
    m = load_example("contact_chain", device)
    s, mass, n = m.build(n_stack=5, h=2e-6)
    s.DoDynamics(0.02)
    s.ChangeFamily(3, 2)
    s.DoDynamics(0.02)
    return dict(f=m.bottom_force(s), mass=mass, n=n, pos=_positions(s, n))


def shake_smoke(device, tmp=None):
    s, n = load_example("shake", device).build(n=60, h=4e-5)
    s.DoDynamics(0.1)
    return dict(pos=_positions(s, n))


def sieve_smoke(device, tmp=None):
    m = load_example("sieve", device)
    s, n_grid, kinds = m.build(n_each=25, h=4e-5)
    s.DoDynamics(0.25)
    small, large = m.passed_fraction(s, n_grid, kinds)
    return dict(small=small, large=large, pos=_positions(s))


def plow_smoke(device, tmp=None):
    s, tracker, n = load_example("plow", device).build(n=80, h=4e-5,
                                                       speed=0.4)
    s.DoDynamics(0.15)
    return dict(x0=tracker.Pos()[0], pos=_positions(s, n))


def hopper_smoke(device, tmp=None):
    m = load_example("hopper", device)
    s, n, gate_speed = m.build(n=60, h=4e-5)
    s.DoDynamics(0.1)
    closed = m.discharged_fraction(s, n)
    m.open_gate(s, 0.5)
    s.DoDynamics(0.35)
    return dict(closed=closed, opened=m.discharged_fraction(s, n),
                pos=_positions(s, n))


def repose2d_smoke(device, tmp=None):
    m = load_example("repose2d", device)
    s, n = m.build(n=60, h=4e-5)
    s.DoDynamics(0.3)
    return dict(angle=m.measure_angle(s, n), pos=_positions(s, n))


def ball_drop_2d_smoke(device, tmp=None):
    s, tracker, bed_top = load_example("ball_drop_2d", device).build(
        n=80, drop_h=0.04, h=2e-5)
    z0 = tracker.Pos()[2]
    s.DoDynamics(0.12)
    return dict(z0=z0, z1=tracker.Pos()[2], pos=_positions(s))


def wheel_slope_slip_smoke(device, tmp=None):
    m = load_example("wheel_slope_slip", device)
    s, tracker, rim = m.build(slope_deg=5.0, h=2e-5)
    s.DoDynamics(0.05)
    return dict(slip=m.measure_slip(s, tracker, rim, t_meas=0.05),
                pos=_positions(s))


def wheel_dp_simplified_smoke(device, tmp=None):
    # tests/test_examples_round3.py builds it from wheel_dp
    m = load_example("wheel_dp", device)
    s, tracker, n = m.build(n_side=4, verbosity="QUIET", h=2e-5, slip=0.3)
    s.DoDynamics(0.08)
    pts, fs = tracker.GetContactForces()
    return dict(pts=pts, pos=_positions(s))


def grc_prep_part2_part3_chain(device, tmp):
    part2 = load_example("grc_prep_part2", device)
    part3 = load_example("grc_prep_part3", device)
    p1, p2, p3 = (os.path.join(tmp, f"p{i}.csv") for i in (1, 2, 3))
    part2.run_part1(p1, n_clumps=60, sim_time=0.08)
    s2, n_extra = part2.run_part2(p1, p2, n_extra=30, sim_time=0.08)
    s3 = part3.run_part3(p2, p3, press_time=0.05)
    xyz = device_view(device).DEMSolver.ReadClumpXyzFromCsv(p3)
    return dict(n_extra=n_extra, n_total=sum(len(v) for v in xyz.values()),
                pos=_positions(s3))


def flexible_mesh_smoke(device, tmp=None):
    m = load_example("flexible_mesh", device)
    s, tracker, plate = m.build(n=50, h=4e-5)
    s.DoDynamics(0.08)
    v0 = np.asarray(plate.vertices, np.float64)
    tracker.UpdateMesh(m.deflect(v0, 0.003))
    s.DoDynamics(0.04)
    pts, fs = tracker.GetContactForces()
    return dict(pts=pts, pos=_positions(s))


def cohesion_reduces_spread(device, tmp=None):
    m = load_example("cohesion_pile", device)
    out = {}
    for label, coh in (("dry", 0.0), ("cohesive", 200.0)):
        s, n = m.build(cohesion=coh, n_side=4, layers=3)
        s.Initialize()
        s.DoDynamics(0.25)
        out[label + "_pos"] = np.asarray(s.GetOwnerPosition())[:n]
        out[label] = m.spread_radius(s, n)
    return out


def mooring_chain_holds(device, tmp=None):
    s, n_links = load_example("mooring_line", device).build(
        n_links=8, weight_mass=0.2)
    s.Initialize(dry_run=True)
    s.SetContactWildcardValueAll("innerInteraction", 2.0)
    s.DoDynamics(0.12)
    return dict(n_links=n_links,
                p=np.asarray(s.GetOwnerPosition())[:n_links + 1])


# --- the API and model checks ------------------------------------------------

def bond_model(k_bond=2e3, break_strain=0.5):
    """test_custom_force_models.py's ``_bond_model`` in torch ops: a
    linear spring while the contact wildcard `unbroken` is 1, broken for
    good past `break_strain` of the summed radii in tension."""
    from dem_engine_tpu_torch.models.force_model import ForceModel

    def fn(ctx):
        stretch = -ctx.overlap
        unbroken = ctx.wildcards["unbroken"]
        breaks = stretch > break_strain * (ctx.a_radius + ctx.b_radius)
        unbroken = torch.where(breaks, 0.0, unbroken)
        f = torch.where(unbroken > 0.5, k_bond * ctx.overlap, 0.0)
        force = f[:, None] * ctx.b2a
        return force, torch.zeros_like(force), {"unbroken": unbroken}

    return ForceModel(name="bond", fn=fn, contact_wildcards=("unbroken",),
                      per_material_props=(), pairwise_props=(),
                      no_contact_force=True)


def _bonded_pair(dem, vel):
    solver = dem.DEMSolver()
    solver.SetVerbosity("QUIET")
    solver.InstructBoxDomainDimension(1, 1, 1)
    solver.LoadMaterial({"E": 1e8, "nu": 0.3})
    solver.DefineContactForceModel(bond_model())
    tmpl = solver.LoadSphereType(0.001, R, solver._materials[0])
    b = solver.AddClumps(tmpl, np.asarray([[-0.0100, 0, 0], [0.0100, 0, 0]]))
    b.SetVel(np.asarray([[-vel, 0, 0], [vel, 0, 0]]))
    solver.MarkFamilyPersistentContact(0)
    solver.SetInitTimeStep(1e-5)
    solver.SetGravitationalAcceleration([0, 0, 0])
    solver.Initialize(dry_run=True)
    solver.SetContactWildcardValueAll("unbroken", 1.0)
    return solver


def bonded_pair_oscillates_not_escapes(device, tmp=None):
    solver = _bonded_pair(device_view(device), 0.05)
    max_gap = 0.0
    for _ in range(20):
        solver.DoDynamics(0.01)
        p = solver.GetOwnerPosition()
        max_gap = max(max_gap, p[1, 0] - p[0, 0] - 2 * R)
    return dict(max_gap=max_gap, p=solver.GetOwnerPosition())


def bond_breaks_at_high_speed(device, tmp=None):
    solver = _bonded_pair(device_view(device), 30.0)
    solver.DoDynamics(0.1)
    return dict(p=solver.GetOwnerPosition())


def slim_fused_tables_fill_on_demand(device, tmp=None):
    """tests/test_api_extras.py::
    test_slim_fused_tables_drop_query_fields_and_fill_on_demand on the
    port, where a built-in Hertz model's SS table is always the fused
    pass's slim table (the JAX test forces that layout through its
    engine's internals): six spheres slightly into a BC plane, 0.05 s;
    the query fills the per-contact fields through B-extras."""
    dem = device_view(device)
    s = dem.DEMSolver()
    s.SetVerbosity("QUIET")
    s.InstructBoxDomainDimension(2, 2, 2)
    mat = s.LoadMaterial({"E": 1e8, "nu": 0.3, "CoR": 0.5, "mu": 0.3,
                          "Crr": 0.0})
    tmpl = s.LoadSphereType(0.001, 0.01, mat)
    s.AddClumps(tmpl, np.stack([np.linspace(-0.5, 0.5, 6), np.zeros(6),
                                np.zeros(6)], axis=1))
    s.SetInitTimeStep(1e-5)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.AddBCPlane([0, 0, -0.00999], [0, 0, 1])
    s.Initialize()
    out = dict(rows0=s.state.ss.force.shape[0])
    s.DoDynamics(0.05)
    out["rows1"] = s.state.ss.force.shape[0]
    out["info"] = s.GetContactDetailedInfo()
    g = s.state.ss.grown(2 * s.state.ss.cap)
    out["grown_rows"] = (g.force.shape[0], g.cpoint.shape[0])
    return out


def adaptive_bin_sim(device, n=60):
    """tests/test_adaptive_bin.py's ``_make_sim`` on the port: 60 spheres
    over a BC plane, h 5e-6, K 10 (not initialised)."""
    rng = np.random.default_rng(3)
    sim = device_view(device).DEMSolver()
    sim.InstructBoxDomainDimension(0.4, 0.4, 0.3)
    mat = sim.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.4,
                            "mu": 0.4, "Crr": 0.0})
    tmpl = sim.LoadSphereType(0.008**3 * 2.6e3, 0.008, mat)
    sim.AddClumps(tmpl, rng.uniform(0.05, 0.35, (n, 3)) * [1, 1, 0.5])
    sim.AddBCPlane([0.2, 0.2, 0.02], [0, 0, 1], mat)
    sim.SetInitTimeStep(5e-6)
    sim.SetGravitationalAcceleration([0, 0, -9.81])
    sim.SetCDUpdateFreq(10)
    return sim


def oversized_bin_simulation(device, tmp=None):
    """test_oversized_bin_simulation_matches_floor: the same 2e-3 s at
    the floor bin size and at a user-fixed 0.1 m bin."""
    sim_a = adaptive_bin_sim(device)
    sim_a.Initialize()
    sim_b = adaptive_bin_sim(device)
    sim_b.SetBinSize(0.1)
    sim_b.Initialize()
    sim_a.DoDynamics(2e-3)
    sim_b.DoDynamics(2e-3)
    return dict(pa=np.asarray(sim_a.GetOwnerPosition()),
                pb=np.asarray(sim_b.GetOwnerPosition()))

# --- a JAX test's own body on the port ---------------------------------------

_TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def port_test_module(file: str, device: str) -> dict:
    """The namespace of the JAX test file `file` (under tests/) bound to
    the port on `device`, built once: its test functions that name jax
    or jnp blanked (line numbers kept), the rest rewritten as
    ``load_example`` rewrites an example (``rewrite_source`` checks that
    nothing names JAX after that)."""
    import ast
    import re

    from dem_engine_tpu_torch.examples import rewrite_source

    path = os.path.join(_TESTS_DIR, file)
    with open(path) as f:
        src = f.read()
    lines = src.splitlines(keepends=True)
    for node in ast.parse(src, path).body:
        if (isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_")
                and re.search(r"\b(jax|jnp)\b",
                              ast.get_source_segment(src, node))):
            first = min([node.lineno] + [d.lineno
                                         for d in node.decorator_list])
            for i in range(first - 1, node.end_lineno):
                lines[i] = "\n"
    code = compile(rewrite_source("".join(lines), path), path, "exec")
    view = device_view(device)
    ns = dict(__name__=f"port_body_{file[:-3]}", __file__=path,
              __example_dem__=view,
              __example_attrs__=lambda mod, *names: tuple(
                  getattr(mod, n) for n in names),
              __example_import__=lambda sib: load_example(sib, view.device))
    exec(code, ns)
    return ns


def jax_test_body(file: str, name: str, device):
    """The test function `name` of the JAX test file `file` (under
    tests/), its own source run on the port as ``load_example`` runs an
    example: ``import dem_engine_tpu as dem`` is the port's names with a
    ``DEMSolver`` on `device`, ``from dem_engine_tpu.X import Y``
    imports ``dem_engine_tpu_torch.X``, an example imports through the
    loader. For bodies that reach the package only through its API and
    numpy; one that computes with jax or jnp raises KeyError."""
    ns = port_test_module(file, str(device))
    if name not in ns:
        raise KeyError(f"{file}::{name} is not a test that runs on the "
                       f"port (it names jax or jnp)")
    return ns[name]
