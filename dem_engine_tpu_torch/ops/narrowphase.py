"""Narrow-phase contact geometry, batched and branch-free.

Each function returns (overlap, b2a_normal, contact_point): b2a points
from body B toward body A, the contact point sits in the middle of the
penetration, and overlap > 0 means touching.
"""

from __future__ import annotations

import torch

from ..defines import ANAL_CYL_INF, ANAL_PLANE, TINY_FLOAT


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def sphere_sphere(pos_a, rad_a, pos_b, rad_b):
    """cp = B + (radB - overlap/2) * b2a, in the frame of the inputs."""
    d = pos_a - pos_b
    dist = _norm(d)
    safe = torch.clamp(dist, min=TINY_FLOAT)
    b2a = d / safe[..., None]
    overlap = rad_a + rad_b - dist
    cp = pos_b + (rad_b - overlap / 2.0)[..., None] * b2a
    return overlap, b2a, cp


def _dot(a, b):
    return torch.sum(a * b, -1)


def closest_point_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, batched over the leading
    axes: Ericson's region tests, evaluated branch-free (the first region
    that holds wins)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp_ = p - c
    d5, d6 = _dot(ab, cp_), _dot(ac, cp_)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    def safe_div(x, y):
        return x / torch.where(torch.abs(y) > TINY_FLOAT, y,
                               torch.ones_like(y))

    v_ab = safe_div(d1, d1 - d3)
    w_ac = safe_div(d2, d2 - d6)
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v_f = vb * denom
    w_f = vc * denom

    # the face point, then each region in reverse priority
    res = a + v_f[..., None] * ab + w_f[..., None] * ac
    res = torch.where(in_bc[..., None], b + w_bc[..., None] * (c - b), res)
    res = torch.where(in_ac[..., None], a + w_ac[..., None] * ac, res)
    res = torch.where(in_c[..., None], c, res)
    res = torch.where(in_ab[..., None], a + v_ab[..., None] * ab, res)
    res = torch.where(in_b[..., None], b, res)
    return torch.where(in_a[..., None], a, res)


def sphere_triangle(center, radius, v0, v1, v2):
    """Sphere (body A) vs a double-sided triangle: b2a points from the
    triangle's closest point toward the sphere centre (the face normal
    where the centre lies on the face)."""
    closest = closest_point_triangle(center, v0, v1, v2)
    d = center - closest
    dist = _norm(d)
    face_n = torch.linalg.cross(v1 - v0, v2 - v0)
    face_n = face_n / torch.clamp(_norm(face_n), min=TINY_FLOAT)[..., None]
    ok = dist > TINY_FLOAT
    b2a = torch.where(
        ok[..., None], d / torch.clamp(dist, min=TINY_FLOAT)[..., None],
        face_n)
    overlap = radius - dist
    cp = torch.where(
        ok[..., None], center - (radius - overlap / 2.0)[..., None] * b2a,
        closest)
    return overlap, b2a, cp


def sphere_plane(center, radius, plane_pos, plane_n):
    """Sphere vs infinite directional plane."""
    dist = torch.sum((center - plane_pos) * plane_n, -1)
    overlap = radius - dist
    cp = center - plane_n * (dist + overlap / 2.0)[..., None]
    return overlap, plane_n.expand_as(cp), cp


def sphere_cylinder(center, radius, cyl_pos, cyl_axis, cyl_rad, normal_sign):
    """Sphere vs infinite cylinder; normal_sign +1 keeps spheres inside
    (drum), -1 outside (pillar)."""
    s2c = cyl_pos - center
    proj = torch.sum(s2c * cyl_axis, -1)
    radial = s2c - proj[..., None] * cyl_axis
    dr = _norm(radial)
    overlap = radius - normal_sign * (cyl_rad - dr)
    ok = dr > TINY_FLOAT
    n = torch.where(
        ok[..., None],
        normal_sign[..., None] * radial
        / torch.clamp(dr, min=TINY_FLOAT)[..., None],
        cyl_axis,
    )
    cp = torch.where(
        ok[..., None],
        center - n * (radius - overlap / 2.0)[..., None],
        center,
    )
    return overlap, n, cp


def sphere_analytical(center, radius, objtype, obj_pos, obj_dir, obj_size,
                      normal_sign):
    """Plane and infinite cylinder, each computed and selected; other
    types report no contact."""
    o_p, n_p, c_p = sphere_plane(center, radius, obj_pos, obj_dir)
    o_c, n_c, c_c = sphere_cylinder(
        center, radius, obj_pos, obj_dir, obj_size[..., 0], normal_sign
    )
    is_cyl1 = objtype == ANAL_CYL_INF
    is_cyl = is_cyl1[..., None]
    overlap = torch.where(is_cyl1, o_c, o_p)
    normal = torch.where(is_cyl, n_c, n_p)
    cp = torch.where(is_cyl, c_c, c_p)
    known = (objtype == ANAL_PLANE) | is_cyl1
    overlap = torch.where(known, overlap, torch.full_like(overlap, -1e30))
    return overlap, normal, cp
