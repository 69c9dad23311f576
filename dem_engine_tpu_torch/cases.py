"""The benchmark scene: a settling bed of 3-sphere clumps on a floor plane.

``build_case`` is the JAX package's ``__graft_entry__._build_case``: the
same lattice, materials, capacities and owner order (clumps, then the
floor plane's owner, then the plate's owner where there is a plate, then
fixed padding dummies up to a multiple of 8 owners). With ``poly_frac``
a fraction of the clumps is scaled by ``poly_ratio`` and stacked on a
coarser lattice above the small ones, and the two-class CD is on; with
``with_mesh`` a fixed triangulated plate is added (family 255).
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
    make_triangles,
    resolve_device,
)
from .models import HertzianForceModel
from .state import SolverConfig

R = 0.005     # sphere radius
RHO = 2600.0  # density


def bed_geometry(n_clumps: int, poly_frac: float = 0.0,
                 poly_ratio: float = 3.0) -> dict:
    """The bed's clump template and lattice: mass, moi and component
    offsets of the unscaled 3-sphere clump; each clump's `scale` (1, or
    poly_ratio for the last `n_large` clumps, which sit on a lattice
    poly_ratio times coarser above the others); LBF-relative clump
    centers (`pos`) and the domain extents (`dims`). The floor plane lies
    at z = 2R."""
    m_sph = RHO * 4 / 3 * np.pi * R**3
    i_sph = 2 / 5 * m_sph * R**2
    moi = np.asarray(
        [i_sph * 3 + 2 * m_sph * R**2, i_sph * 3 + 2 * m_sph * R**2,
         3 * i_sph]
    )
    rel = np.asarray([[0, 0, -R], [0, 0, 0], [0, 0, R]])

    n = n_clumps
    n_large = int(n * poly_frac)
    n_small = n - n_large
    scale = np.ones(n)
    scale[n_small:] = poly_ratio
    # lattice of clumps, nearly touching
    nx = int(np.ceil(n_small ** (1 / 3)))
    ny = nx
    nz = int(np.ceil(n_small / (nx * ny)))
    dx, dz = 1.99 * R, 3.99 * R
    idx = np.arange(nx * ny * nz)[:n_small]
    ii, jj, kk = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    pos = np.stack([ii * dx, jj * dx, kk * dz + 2 * R + dz / 2], axis=-1)
    dims = np.asarray([nx * dx + 20 * R, ny * dx + 20 * R, nz * dz + 40 * R])
    if n_large:
        dxL, dzL = dx * poly_ratio, dz * poly_ratio
        nxL = max(1, int(nx * dx / dxL))
        nyL = nxL
        nzL = int(np.ceil(n_large / (nxL * nyL)))
        idxL = np.arange(nxL * nyL * nzL)[:n_large]
        iL, jL = idxL % nxL, (idxL // nxL) % nyL
        kL = idxL // (nxL * nyL)
        z0L = nz * dz + 2 * R + dz
        posL = np.stack([iL * dxL, jL * dxL, kL * dzL + z0L + dzL / 2],
                        axis=-1)
        pos = np.concatenate([pos, posL])
        dims[2] = z0L + nzL * dzL + 40 * R * poly_ratio
        dims[0] = max(dims[0], nxL * dxL + 20 * R)
        dims[1] = max(dims[1], nyL * dxL + 20 * R)
    pos[:, 0] += 10 * R
    pos[:, 1] += 10 * R
    return dict(mass=3 * m_sph, moi=moi, rel=rel, pos=pos, dims=dims,
                scale=scale, n_large=n_large)


def plate_mesh(plate_grid: int):
    """(vertices (V, 3), faces (2 g^2, 3)) of the square plate, 12R wide,
    in g x g quads of two triangles each, in the body frame."""
    g = plate_grid
    xs = np.linspace(-6 * R, 6 * R, g + 1)
    verts = np.asarray([[x, y, 0.0] for x in xs for y in xs])
    v00 = (np.arange(g)[:, None] * (g + 1) + np.arange(g)[None, :]).ravel()
    v10 = v00 + g + 1
    faces = np.stack([np.stack([v00, v10, v10 + 1], 1),
                      np.stack([v00, v10 + 1, v00 + 1], 1)], 1)
    return verts, faces.reshape(-1, 3)


def _fixed_owners(pos, voxel_size, device):
    k = len(pos)
    return make_owners(pos=np.asarray(pos), voxel_size=voxel_size,
                       family=[255] * k, mass=[1e30] * k,
                       moi=np.full((k, 3), 1e30), device=device)


def build_case(n_clumps: int, update_freq: int = 20, poly_frac: float = 0.0,
               poly_ratio: float = 3.0, with_mesh: bool = False,
               plate_grid: int = 1, plate_z=None, device="cuda"):
    """Returns (cfg, state, params) of an `n_clumps` bed on `device` (the
    card unless the caller asks for the CPU). The plate lies at height
    `plate_z` above the domain's lower corner (default: 6R below its
    top), centred over the bed."""
    device = resolve_device(device)
    geo = bed_geometry(n_clumps, poly_frac, poly_ratio)
    mass, moi, rel = geo["mass"], geo["moi"], geo["rel"]
    pos, dims, scale = geo["pos"], geo["dims"], geo["scale"]
    n, n_large = n_clumps, geo["n_large"]

    voxel_size = float(dims.max()) / 2**20
    cfg = SolverConfig(
        voxel_size=voxel_size,
        integrator=TimeIntegrator.CENTERED_DIFFERENCE,
        force_model=HertzianForceModel(),
        # 12 contacts/clump below 512k clumps, 9 above (growth is lossless)
        cap_ss=max(256, (4 if n_clumps < 524288 else 3) * n_clumps * 3),
        cap_st=256 if with_mesh else 8,
        cap_sa=max(256, 4 * n_clumps),
        cd_two_class=n_large > 0,
    )
    clumps = make_owners(pos=pos, voxel_size=voxel_size,
                         mass=mass * scale**3,
                         moi=moi[None, :] * scale[:, None]**5,
                         device=device)
    center = [dims[0] / 2, dims[1] / 2]
    groups = [clumps, _fixed_owners([[*center, 2 * R]], voxel_size,
                                    device)]
    tris = None
    if with_mesh:
        z = float(dims[2]) - 6 * R if plate_z is None else float(plate_z)
        groups.append(_fixed_owners([[*center, z]], voxel_size, device))
        verts, faces = plate_mesh(plate_grid)
        tris = make_triangles(owner=[n + 1] * len(faces),
                              nodes=verts[faces], device=device)
    pad = (-(n + len(groups) - 1)) % 8
    if pad:
        groups.append(_fixed_owners([[*center, dims[2] - 2 * R]] * pad,
                                    voxel_size, device))
    owners = concat_owners(*groups)
    sph_scale = np.repeat(scale, 3)
    spheres = make_spheres(
        owner=np.repeat(np.arange(n), 3),
        relpos=np.tile(rel, (n, 1)) * sph_scale[:, None],
        radius=R * sph_scale,
        device=device,
    )
    anals = make_analyticals(
        owner=[n], objtype=[ANAL_PLANE], relpos=np.zeros((1, 3)),
        direction=[[0, 0, 1.0]], size=np.zeros((1, 3)), normal_sign=[1.0],
        device=device,
    )
    state = make_state(owners, spheres, cfg, tris=tris, anals=anals)
    params = make_params(
        h=5e-6, gravity=[0, 0, -9.81], domain=dims,
        materials={"E": np.asarray([1e9], np.float32),
                   "nu": np.asarray([0.3], np.float32)},
        pair_materials={
            "CoR": np.asarray([[0.5]], np.float32),
            "mu": np.asarray([[0.4]], np.float32),
            "Crr": np.asarray([[0.01]], np.float32),
        },
        update_freq=update_freq,
        cls_thr=R * float(np.sqrt(poly_ratio)) if n_large else 0.0,
        device=device,
    )
    return cfg, state, params


# ---------------------------------------------------------------------------
# custom force models of the cohesive bed and the bonded block
# ---------------------------------------------------------------------------

FRICTION_HISTORY = ("delta_tan_x", "delta_tan_y", "delta_tan_z", "delta_time")


def cohesion_model():
    """Hertz-Mindlin plus cohesion, the shape of DEME's
    ForceModelWithCohesion user script: ``Cohesion * m_eff`` along -b2a
    while two bodies overlap, with `Cohesion` a pairwise material
    property. The cohesion term is scaled by the product of the two
    owners' owner wildcard `coh_scale` and of the two spheres' geometry
    wildcard `stick` (an analytical or mesh side has no `stick` and
    counts 1), so that a family can be made to stick less."""
    import torch

    from .models.force_model import ForceModel
    from .models.hertz import _full_fn

    def fn(ctx):
        force, torque, wc = _full_fn(ctx)
        m_eff = ctx.a_mass * ctx.b_mass / torch.clamp(
            ctx.a_mass + ctx.b_mass, min=1e-30)
        scale = ctx.a_owner_wc["coh_scale"] * ctx.b_owner_wc["coh_scale"]
        scale = scale * ctx.a_geo_wc["stick"]
        if "stick" in ctx.b_geo_wc:
            scale = scale * ctx.b_geo_wc["stick"]
        f_coh = torch.where(ctx.overlap > 0.0,
                            ctx.pair("Cohesion") * m_eff * scale, 0.0)
        return force - f_coh[:, None] * ctx.b2a, torque, wc

    return ForceModel(
        name="hertz_cohesion", fn=fn, contact_wildcards=FRICTION_HISTORY,
        owner_wildcards=("coh_scale",), geo_wildcards=("stick",),
        per_material_props=("E", "nu"),
        pairwise_props=("CoR", "mu", "Crr", "Cohesion"))


def bond_model(k_bond=1e5, break_strain=0.015, kn_contact=1e5, damp=0.25):
    """The bonded-block model of DEMdemo_Fracture_Box: a damped linear
    spring on every contact whose wildcard `unbroken` is 1, which breaks
    for good past `break_strain` of the summed radii in tension or in
    compression; a plain repulsive spring on unbonded overlaps."""
    import torch

    from .models.force_model import ForceModel

    def fn(ctx):
        stretch = -ctx.overlap
        unbroken = ctx.wildcards["unbroken"]
        lim = break_strain * (ctx.a_radius + ctx.b_radius)
        breaks = (stretch > lim) | (ctx.overlap > lim)
        unbroken = torch.where(breaks, 0.0, unbroken)
        f_bond = torch.where(unbroken > 0.5, k_bond * ctx.overlap, 0.0)
        f_contact = torch.where((unbroken <= 0.5) & (ctx.overlap > 0),
                                kn_contact * ctx.overlap, 0.0)
        m_eff = ctx.a_mass * ctx.b_mass / (ctx.a_mass + ctx.b_mass)
        vn = torch.sum((ctx.a_lin_vel - ctx.b_lin_vel) * ctx.b2a, dim=-1)
        active = (unbroken > 0.5) | (ctx.overlap > 0)
        c = 2.0 * damp * torch.sqrt(k_bond * m_eff)
        f_damp = torch.where(active, -c * vn, 0.0)
        force = (f_bond + f_contact + f_damp)[:, None] * ctx.b2a
        return force, torch.zeros_like(force), {"unbroken": unbroken}

    return ForceModel(
        name="bond", fn=fn, contact_wildcards=("unbroken",),
        per_material_props=(), pairwise_props=(), no_contact_force=True)
