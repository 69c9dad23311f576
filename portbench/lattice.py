"""The settling bed's clump template and lattice, from a configuration.

A frozen copy of the arithmetic of the port's ``cases.bed_geometry``
(monodisperse part): a cubic-ish lattice of 3-sphere clumps, pitch
``pitch_xy_r`` R across and ``pitch_z_r`` R up, over a floor plane at
``floor_z_r`` R, in a box ``margin_xy_r`` R wider and ``margin_z_r`` R
taller than the lattice. Positions are relative to the box's lower
corner. Plain numpy: the reference and the scene both read it,
so later edits to the program do not move the yardstick.
"""

from __future__ import annotations

import numpy as np


def template(cfg: dict) -> dict:
    """Mass, principal moments and sphere offsets of the clump: spheres
    of radius R and density rho at z offsets ``spheres_z_r`` R, a sphere's
    own moment plus the parallel-axis term of each offset."""
    c = cfg["clump"]
    r, rho = c["radius"], c["density"]
    rel = np.asarray([[0.0, 0.0, z * r] for z in c["spheres_z_r"]])
    m_sph = rho * 4.0 / 3.0 * np.pi * r**3
    i_sph = 2.0 / 5.0 * m_sph * r**2
    k = len(rel)
    d2 = (rel**2).sum(1)
    moi = np.asarray([
        k * i_sph + m_sph * float((d2 - rel[:, 0] ** 2).sum()),
        k * i_sph + m_sph * float((d2 - rel[:, 1] ** 2).sum()),
        k * i_sph + m_sph * float((d2 - rel[:, 2] ** 2).sum()),
    ])
    return dict(mass=k * m_sph, moi=moi, rel=rel, radius=r)


def bed(cfg: dict) -> dict:
    """Clump centres (n, 3), box extents (3,) and the floor's height,
    all relative to the box's lower corner."""
    n = int(cfg["n_clumps"])
    r = cfg["clump"]["radius"]
    lat = cfg["lattice"]
    nx = int(np.ceil(n ** (1 / 3)))
    # guard the float cube root: the smallest nx with nx^3 >= n
    while (nx - 1) ** 3 >= n:
        nx -= 1
    while nx**3 < n:
        nx += 1
    nz = int(np.ceil(n / (nx * nx)))
    dx, dz = lat["pitch_xy_r"] * r, lat["pitch_z_r"] * r
    idx = np.arange(n)
    ii, jj, kk = idx % nx, (idx // nx) % nx, idx // (nx * nx)
    floor = lat["floor_z_r"] * r
    pos = np.stack([ii * dx, jj * dx, kk * dz + floor + dz / 2], axis=-1)
    mxy, mz = lat["margin_xy_r"] * r, lat["margin_z_r"] * r
    dims = np.asarray([nx * dx + mxy, nx * dx + mxy, nz * dz + mz])
    pos[:, 0] += mxy / 2
    pos[:, 1] += mxy / 2
    return dict(pos=pos, dims=dims, floor_z=floor)


def initial_velocities(cfg: dict, seed: int) -> np.ndarray:
    """(n, 3) initial clump velocities drawn from the seed: each
    component uniform in [-v, v], v = ``seed_draw.init_vel_max``. The
    packing, sizes and counts do not depend on the seed."""
    v = float(cfg["seed_draw"]["init_vel_max"])
    rng = np.random.default_rng(int(seed))
    return rng.uniform(-v, v, size=(int(cfg["n_clumps"]), 3))


def families(cfg: dict) -> np.ndarray:
    """(n,) clump families: family 1 on every ``every``-th clump where the
    configuration has a ``family_one`` rule, else 0."""
    n = int(cfg["n_clumps"])
    rule = cfg.get("family_one")
    if not rule:
        return np.zeros(n, np.int32)
    return np.where(np.arange(n) % int(rule["every"]) == 0, 1,
                    0).astype(np.int32)
