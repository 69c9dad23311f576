"""Initial-packing samplers.

Parity target: reference utils/Samplers.hpp (GridSampler :536, HCPSampler
:498, PDSampler Poisson-disk :271, region helpers :80-180, one-shot helpers
DEMBoxGridSampler/DEMBoxHCPSampler :576-611). Host-side numpy.
"""

from __future__ import annotations

import numpy as np


class Sampler:
    """Base sampler over a separation distance; subclasses fill a generic
    axis-aligned bounding region then the Sample* helpers crop it."""

    def __init__(self, separation: float):
        self.separation = float(separation)

    def _generate(self, lo, hi) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def SampleBox(self, center, half_dims) -> np.ndarray:
        c = np.asarray(center, np.float64)
        h = np.asarray(half_dims, np.float64)
        pts = self._generate(c - h, c + h)
        keep = np.all(np.abs(pts - c) <= h + 1e-12, axis=1)
        return pts[keep]

    def SampleSphere(self, center, radius) -> np.ndarray:
        c = np.asarray(center, np.float64)
        pts = self._generate(c - radius, c + radius)
        keep = np.linalg.norm(pts - c, axis=1) <= radius
        return pts[keep]

    def SampleCylinderX(self, center, radius, half_height):
        return self._sample_cyl(center, radius, half_height, 0)

    def SampleCylinderY(self, center, radius, half_height):
        return self._sample_cyl(center, radius, half_height, 1)

    def SampleCylinderZ(self, center, radius, half_height):
        return self._sample_cyl(center, radius, half_height, 2)

    def _sample_cyl(self, center, radius, half_height, axis):
        c = np.asarray(center, np.float64)
        half = np.full(3, radius, np.float64)
        half[axis] = half_height
        pts = self._generate(c - half, c + half)
        r_axes = [i for i in range(3) if i != axis]
        rad = np.linalg.norm(pts[:, r_axes] - c[r_axes], axis=1)
        keep = (rad <= radius) & (np.abs(pts[:, axis] - c[axis]) <= half_height)
        return pts[keep]


class GridSampler(Sampler):
    """Regular cubic grid (reference GridSampler, Samplers.hpp:536)."""

    def _generate(self, lo, hi):
        axes = [
            np.arange(lo[i], hi[i] + 1e-12, self.separation) for i in range(3)
        ]
        g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        return g.reshape(-1, 3)


class HCPSampler(Sampler):
    """Hexagonal close packing (reference HCPSampler, Samplers.hpp:498)."""

    def _generate(self, lo, hi):
        d = self.separation
        dy = d * np.sqrt(3.0) / 2.0
        dz = d * np.sqrt(6.0) / 3.0
        pts = []
        k = 0
        z = lo[2]
        while z <= hi[2] + 1e-12:
            j = 0
            y = lo[1] + (d * np.sqrt(3) / 6.0 if k % 2 else 0.0)
            while y <= hi[1] + 1e-12:
                x0 = lo[0] + (d / 2.0 if (j + k) % 2 else 0.0)
                xs = np.arange(x0, hi[0] + 1e-12, d)
                row = np.stack(
                    [xs, np.full_like(xs, y), np.full_like(xs, z)], axis=-1
                )
                pts.append(row)
                y += dy
                j += 1
            z += dz
            k += 1
        return (
            np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))
        )


class PDSampler(Sampler):
    """Poisson-disk sampling via Bridson's algorithm (reference PDSampler,
    Samplers.hpp:271 — also Bridson-based)."""

    def __init__(self, separation: float, seed: int = 0, k_tries: int = 30):
        super().__init__(separation)
        self.seed = seed
        self.k_tries = k_tries

    def _generate(self, lo, hi):
        from ..core import pd_sample as _native_pd

        native = _native_pd(lo, hi, self.separation, seed=self.seed,
                            k_tries=self.k_tries)
        if native is not None:
            return native
        rng = np.random.default_rng(self.seed)
        r = self.separation
        dims = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
        cell = r / np.sqrt(3.0)
        gshape = np.maximum(np.ceil(dims / cell).astype(int), 1)
        grid = -np.ones(gshape, dtype=np.int64)
        pts = []
        active = []

        def gidx(p):
            return tuple(
                np.minimum(((p - lo) / cell).astype(int), gshape - 1)
            )

        def fits(p):
            gi = np.asarray(gidx(p))
            lo_i = np.maximum(gi - 2, 0)
            hi_i = np.minimum(gi + 3, gshape)
            sub = grid[
                lo_i[0]:hi_i[0], lo_i[1]:hi_i[1], lo_i[2]:hi_i[2]
            ].reshape(-1)
            sub = sub[sub >= 0]
            if sub.size == 0:
                return True
            d = np.linalg.norm(np.asarray(pts)[sub] - p, axis=1)
            return bool((d >= r).all())

        p0 = lo + rng.uniform(size=3) * dims
        pts.append(p0)
        grid[gidx(p0)] = 0
        active.append(0)
        while active:
            ai = rng.integers(len(active))
            base = pts[active[ai]]
            placed = False
            for _ in range(self.k_tries):
                rad = r * (1 + rng.uniform())
                v = rng.normal(size=3)
                v *= rad / np.linalg.norm(v)
                p = base + v
                if np.any(p < lo) or np.any(p > hi):
                    continue
                if fits(p):
                    pts.append(p)
                    grid[gidx(p)] = len(pts) - 1
                    active.append(len(pts) - 1)
                    placed = True
                    break
            if not placed:
                active.pop(ai)
        return np.asarray(pts)


def DEMBoxGridSampler(center, half_dims, spacing_x, spacing_y=None,
                      spacing_z=None):
    """One-shot grid fill of a box (reference Samplers.hpp:576)."""
    sy = spacing_x if spacing_y is None else spacing_y
    sz = spacing_x if spacing_z is None else spacing_z
    c = np.asarray(center, np.float64)
    h = np.asarray(half_dims, np.float64)
    axes = [
        np.arange(c[i] - h[i], c[i] + h[i] + 1e-12, s)
        for i, s in enumerate((spacing_x, sy, sz))
    ]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def DEMBoxHCPSampler(center, half_dims, spacing):
    """One-shot HCP fill of a box (reference Samplers.hpp:594)."""
    return HCPSampler(spacing).SampleBox(center, half_dims)


def DEMCylSurfSampler(center, axis, radius, half_height, spacing):
    """Points on a cylinder surface (reference CylSurfSampler)."""
    c = np.asarray(center, np.float64)
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    n_circ = max(int(np.floor(2 * np.pi * radius / spacing)), 3)
    n_len = max(int(np.floor(2 * half_height / spacing)) + 1, 1)
    # build an orthonormal frame around the axis
    ref = np.asarray([1.0, 0, 0]) if abs(a[0]) < 0.9 else np.asarray([0, 1.0, 0])
    u = np.cross(a, ref)
    u /= np.linalg.norm(u)
    v = np.cross(a, u)
    pts = []
    for i in range(n_len):
        z = -half_height + (2 * half_height) * (i / max(n_len - 1, 1))
        for j in range(n_circ):
            th = 2 * np.pi * j / n_circ
            pts.append(c + a * z + radius * (np.cos(th) * u + np.sin(th) * v))
    return np.asarray(pts)
