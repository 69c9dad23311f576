"""What the reference knows of a cell, from its configuration alone."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import lattice


class Scene:
    """Spheres, owners and materials of a configuration on a device, in
    the reference's dtype. Owners are the clumps, then the floor plane
    (the order in which the configuration adds them)."""

    def __init__(self, cfg: dict, traffic: dict, device, dtype):
        self.cfg, self.dt, self.dev = cfg, dtype, device
        t = lattice.template(cfg)
        geo = lattice.bed(cfg)
        n = int(cfg["n_clumps"])
        k = len(t["rel"])
        self.n, self.k, self.n_spheres = n, k, n * k
        self.radius = float(t["radius"])
        self.rel = torch.as_tensor(t["rel"], dtype=dtype, device=device)
        self.mass = float(t["mass"])
        self.moi = torch.as_tensor(t["moi"], dtype=dtype, device=device)
        self.floor_z = float(geo["floor_z"])
        self.dims = geo["dims"]
        self.h = float(cfg["time_step"])
        self.K = int(traffic["cd_update_freq"])
        self.g = torch.as_tensor(cfg["gravity"], dtype=dtype, device=device)
        self.g_mag = float(np.linalg.norm(cfg["gravity"]))
        self.multi = float(cfg["expand_safety_multi"])
        self.adder = float(cfg["expand_safety_adder"])
        self.plane_mass = float(cfg["plane_mass"])
        m = cfg["material"]
        E, nu = float(m["E"]), float(m["nu"])
        # one material on both sides: the pair mix of DEM-Engine's
        # Hertz-Mindlin model
        self.E_eff = 1.0 / (2.0 * (1.0 - nu * nu) / E)
        self.G_eff = 1.0 / (2.0 * 2.0 * (2.0 - nu) * (1.0 + nu) / E)
        loge = math.log(max(float(m["CoR"]), 1e-12))
        self.beta = loge / math.sqrt(loge * loge + math.pi**2)
        self.mu, self.crr = float(m["mu"]), float(m["Crr"])
        coh = cfg["force_model"].get("cohesion")
        self.cohesion = float(m[coh["pair_prop"]]) if coh else 0.0
        fam = torch.as_tensor(lattice.families(cfg), device=device)
        if coh:
            # the owner wildcard: its initial value on every clump, 0 on
            # the zeroed family and on the floor (no clump)
            scale = torch.full((n + 1,), float(coh["owner_wildcard_init"]),
                               dtype=dtype, device=device)
            zero = fam == int(coh["owner_wildcard_zero_family"])
            scale[:n] = torch.where(zero, 0.0, scale[:n])
            scale[n] = 0.0
            self.coh_owner = scale
            self.stick = float(coh["geo_wildcard_init"])
        else:
            self.coh_owner = None
            self.stick = 1.0

    def owner_of(self, sphere):
        return torch.div(sphere, self.k, rounding_mode="floor")

    def rel_of(self, sphere):
        return self.rel[sphere % self.k]
