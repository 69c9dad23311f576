"""Contact detection of one refresh, by a plain cell list.

Each sphere's reach is its radius plus a margin for K steps of drift:
(|v| + |omega| (|offset| + r)) times the expansion multiplier, plus the
adder, over K h, plus half of |g| (K h)^2 (DEM-Engine's margin rule, as
the configuration states it). Two spheres of different clumps are a
pair where their distance is below the sum of their reaches; a sphere
and the floor where its margined overlap is above 0.
"""

from __future__ import annotations

import itertools

import torch

from . import quat


def sphere_state(scene, owners):
    """World sphere centres (S, 3), reaches (S,), and the per-sphere
    margin."""
    dt = scene.dt
    s = torch.arange(scene.n_spheres, device=scene.dev)
    own = scene.owner_of(s)
    rel = scene.rel_of(s)
    pos = owners["pos"][own] + quat.rotate(owners["quat"][own], rel)
    arm = torch.sqrt((rel * rel).sum(1)) + scene.radius
    v = torch.sqrt((owners["vel"] ** 2).sum(1))[own]
    w = torch.sqrt((owners["omg"] ** 2).sum(1))[own]
    t = scene.K * scene.h
    margin = ((v + w * arm) * scene.multi + scene.adder) * t \
        + 0.5 * scene.g_mag * t * t
    reach = (scene.radius + margin).to(dt)
    return pos, reach, margin


def ss_pairs(scene, pos, reach, block=1 << 15):
    """(a, b, gap) of every sphere pair of different clumps with
    distance < reach_a + reach_b, a < b; gap = distance - reach sum."""
    dev = pos.device
    S = pos.shape[0]
    cell = 2.0 * float(reach.max())
    lo = pos.min(0).values
    ci = torch.floor((pos - lo) / cell).long()
    nc = ci.max(0).values + 1
    key = (ci[:, 0] * nc[1] + ci[:, 1]) * nc[2] + ci[:, 2]
    order = torch.argsort(key)
    ucell, counts = torch.unique_consecutive(key[order], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    mocc = int(counts.max())
    offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)),
                        device=dev)
    slot = torch.arange(mocc, device=dev)
    own = scene.owner_of(torch.arange(S, device=dev))
    out_a, out_b, out_g = [], [], []
    for i0 in range(0, S, block):
        i = torch.arange(i0, min(i0 + block, S), device=dev)
        nb = ci[i][:, None, :] + offs[None]                   # (B, 27, 3)
        ok = ((nb >= 0) & (nb < nc)).all(-1)
        nkey = (nb[..., 0] * nc[1] + nb[..., 1]) * nc[2] + nb[..., 2]
        u = torch.searchsorted(ucell, nkey).clamp(max=ucell.shape[0] - 1)
        ok &= ucell[u] == nkey
        st = starts[u]
        ct = torch.where(ok, counts[u], 0)
        valid = slot[None, None, :] < ct[..., None]           # (B, 27, m)
        sl = (st[..., None] + slot).clamp(max=S - 1)
        j = order[sl]
        ii = i[:, None, None].expand_as(j)
        valid &= (j > ii) & (own[j] != own[ii])
        ii, j = ii[valid], j[valid]
        d = pos[ii] - pos[j]
        dist = torch.sqrt((d * d).sum(1))
        gap = dist - (reach[ii] + reach[j])
        hit = gap < 0
        out_a.append(ii[hit])
        out_b.append(j[hit])
        out_g.append(gap[hit])
    return torch.cat(out_a), torch.cat(out_b), torch.cat(out_g)


def pair_gap(pos, reach, a, b):
    """distance - reach sum of given sphere pairs."""
    d = pos[a] - pos[b]
    return torch.sqrt((d * d).sum(1)) - (reach[a] + reach[b])


def plane_gap(scene, pos, margin):
    """Minus the margined overlap of every sphere with the floor: the
    floor's own margin is the adder over K h (it does not move)."""
    t = scene.K * scene.h
    ovl = scene.radius - (pos[:, 2] - scene.floor_z) + margin \
        + scene.adder * t
    return -ovl


def sa_pairs(scene, pos, margin):
    """(sphere ids, gap) of the spheres in reach of the floor."""
    gap = plane_gap(scene, pos, margin)
    a = torch.nonzero(gap < 0).reshape(-1)
    return a, gap[a]
