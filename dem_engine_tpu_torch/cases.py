"""The benchmark scene: a settling bed of 3-sphere clumps on a floor plane.

``build_case`` is the monodisperse, mesh-free part of the JAX package's
``__graft_entry__._build_case``: the same lattice, materials, capacities
and owner order (clumps, then the floor plane's owner, then fixed
padding dummies up to a multiple of 8 owners).
"""

from __future__ import annotations

import numpy as np

from .defines import ANAL_PLANE, TimeIntegrator
from .initializer import (
    concat_owners,
    make_analyticals,
    make_owners,
    make_params,
    make_spheres,
    make_state,
    resolve_device,
)
from .models import HertzianForceModel
from .state import SolverConfig

R = 0.005     # sphere radius
RHO = 2600.0  # density


def bed_geometry(n_clumps: int) -> dict:
    """The bed's clump template and lattice: mass, moi and component
    offsets of the 3-sphere clump; LBF-relative clump centers (`pos`) and
    the domain extents (`dims`). The floor plane lies at z = 2R."""
    m_sph = RHO * 4 / 3 * np.pi * R**3
    i_sph = 2 / 5 * m_sph * R**2
    moi = np.asarray(
        [i_sph * 3 + 2 * m_sph * R**2, i_sph * 3 + 2 * m_sph * R**2,
         3 * i_sph]
    )
    rel = np.asarray([[0, 0, -R], [0, 0, 0], [0, 0, R]])

    n = n_clumps
    # lattice of clumps, nearly touching
    nx = int(np.ceil(n ** (1 / 3)))
    ny = nx
    nz = int(np.ceil(n / (nx * ny)))
    dx, dz = 1.99 * R, 3.99 * R
    idx = np.arange(nx * ny * nz)[:n]
    ii, jj, kk = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    pos = np.stack([ii * dx, jj * dx, kk * dz + 2 * R + dz / 2], axis=-1)
    dims = np.asarray([nx * dx + 20 * R, ny * dx + 20 * R, nz * dz + 40 * R])
    pos[:, 0] += 10 * R
    pos[:, 1] += 10 * R
    return dict(mass=3 * m_sph, moi=moi, rel=rel, pos=pos, dims=dims)


def build_case(n_clumps: int, update_freq: int = 20, device="cuda"):
    """Returns (cfg, state, params) of an `n_clumps` bed on `device` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    geo = bed_geometry(n_clumps)
    mass, moi, rel = geo["mass"], geo["moi"], geo["rel"]
    pos, dims = geo["pos"], geo["dims"]
    n = n_clumps

    voxel_size = float(dims.max()) / 2**20
    cfg = SolverConfig(
        voxel_size=voxel_size,
        integrator=TimeIntegrator.CENTERED_DIFFERENCE,
        force_model=HertzianForceModel(),
        # 12 contacts/clump below 512k clumps, 9 above (growth is lossless)
        cap_ss=max(256, (4 if n_clumps < 524288 else 3) * n_clumps * 3),
        cap_st=8,
        cap_sa=max(256, 4 * n_clumps),
    )
    clumps = make_owners(pos=pos, voxel_size=voxel_size, mass=np.full(n, mass),
                         moi=np.tile(moi, (n, 1)), device=device)
    plane = make_owners(
        pos=np.asarray([[dims[0] / 2, dims[1] / 2, 2 * R]]),
        voxel_size=voxel_size, family=[255], mass=[1e30],
        moi=np.full((1, 3), 1e30), device=device,
    )
    groups = [clumps, plane]
    pad = (-(n + 1)) % 8
    if pad:
        groups.append(make_owners(
            pos=np.tile(np.asarray([[dims[0] / 2, dims[1] / 2,
                                     dims[2] - 2 * R]]), (pad, 1)),
            voxel_size=voxel_size, family=[255] * pad,
            mass=[1e30] * pad, moi=np.full((pad, 3), 1e30), device=device,
        ))
    owners = concat_owners(*groups)
    spheres = make_spheres(
        owner=np.repeat(np.arange(n), 3),
        relpos=np.tile(rel, (n, 1)),
        radius=np.full(3 * n, R),
        device=device,
    )
    anals = make_analyticals(
        owner=[n], objtype=[ANAL_PLANE], relpos=np.zeros((1, 3)),
        direction=[[0, 0, 1.0]], size=np.zeros((1, 3)), normal_sign=[1.0],
        device=device,
    )
    state = make_state(owners, spheres, cfg, anals=anals)
    params = make_params(
        h=5e-6, gravity=[0, 0, -9.81], domain=dims,
        materials={"E": np.asarray([1e9], np.float32),
                   "nu": np.asarray([0.3], np.float32)},
        pair_materials={
            "CoR": np.asarray([[0.5]], np.float32),
            "mu": np.asarray([[0.4]], np.float32),
            "Crr": np.asarray([[0.01]], np.float32),
        },
        update_freq=update_freq, device=device,
    )
    return cfg, state, params
