"""Builds a cell's scene through ``DEMSolver``'s public calls.

The configuration gives the clump template, lattice, materials, force
model, step and margins; the traffic gives the CD cadence and the tuner
switches; the seed draws the initial velocities (``lattice``). The same
calls as ``chip_smoke.api_solver`` and ``chip_smoke.custom_solver``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from . import lattice

CONFIGS = Path(__file__).resolve().parent / "configs"


def force_model(cfg: dict, config_dir: Path = CONFIGS):
    """The configuration's force model: None for the built-in
    Hertz-Mindlin, else the ``force_model()`` of its script."""
    fm = cfg["force_model"]
    if fm["kind"] == "hertz_mindlin":
        return None
    path = config_dir / fm["script"]
    spec = importlib.util.spec_from_file_location(
        "portbench_model_" + cfg["name"], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.force_model()


def build_solver(cfg: dict, traffic: dict, seed: int, device: str,
                 config_dir: Path = CONFIGS):
    """An initialised ``DEMSolver`` on `device` for the cell."""
    from dem_engine_tpu_torch import DEMSolver

    tmpl_g = lattice.template(cfg)
    geo = lattice.bed(cfg)
    dims = geo["dims"]
    r = tmpl_g["radius"]
    s = DEMSolver(device=device)
    s.SetVerbosity("WARNING")
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial(dict(cfg["material"]))
    model = force_model(cfg, config_dir)
    if model is not None:
        s.DefineContactForceModel(model)
    tmpl = s.LoadClumpType(tmpl_g["mass"], tmpl_g["moi"],
                           [r] * len(tmpl_g["rel"]), tmpl_g["rel"], mat)
    b = s.AddClumps(tmpl, geo["pos"] - dims / 2)
    b.SetVel(lattice.initial_velocities(cfg, seed))
    if cfg.get("family_one"):
        b.SetFamilies(lattice.families(cfg))
    coh = cfg["force_model"].get("cohesion")
    if coh:
        b.AddOwnerWildcard(coh["owner_wildcard"], coh["owner_wildcard_init"])
        b.AddGeometryWildcard(coh["geo_wildcard"],
                              np.full(b.n, coh["geo_wildcard_init"]))
    plane = s.AddBCPlane([0, 0, -dims[2] / 2 + geo["floor_z"]], [0, 0, 1],
                         mat)
    plane.SetMass(cfg["plane_mass"])
    s.SetInitTimeStep(cfg["time_step"])
    s.SetGravitationalAcceleration(cfg["gravity"])
    s.SetIntegrator(cfg["integrator"])
    s.SetExpandSafetyMultiplier(cfg["expand_safety_multi"])
    s.SetExpandSafetyAdder(cfg["expand_safety_adder"])
    s.SetCDUpdateFreq(int(traffic["cd_update_freq"]))
    s.UseAdaptiveUpdateFreq(bool(traffic["adaptive_update_freq"]))
    s.UseAdaptiveBinSize(bool(traffic["adaptive_bin_size"]))
    s.Initialize()
    if coh:
        s.SetFamilyOwnerWildcardValue(coh["owner_wildcard_zero_family"],
                                      coh["owner_wildcard"], 0.0)
    return s
