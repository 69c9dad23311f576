"""Wavefront OBJ loading (parity: core/utils/WavefrontMeshLoader.hpp)."""

from __future__ import annotations

import numpy as np


def load_obj(path, with_normals=False):
    """Parse a Wavefront OBJ into (vertices (V,3), faces (T,3) int32)
    [, facet_normals (T,3) or None with `with_normals`].

    Polygon faces are fan-triangulated; v/vt/vn index forms and negative
    (relative) indices are supported. Facet normals are the mean of the
    face's source `vn` entries (None if the file declares none).
    """
    verts = []
    faces = []
    vns = []
    face_vns = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "vn" and len(parts) >= 4:
                vns.append([float(parts[1]), float(parts[2]),
                            float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                nidx = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    i = int(comps[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                    if len(comps) >= 3 and comps[2]:
                        j = int(comps[2])
                        nidx.append(j - 1 if j > 0 else len(vns) + j)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    face_vns.append([nidx[0], nidx[k], nidx[k + 1]]
                                    if len(nidx) == len(idx) else None)
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    fc = np.asarray(faces, np.int32).reshape(-1, 3)
    if not with_normals:
        return v, fc
    normals = None
    if vns and all(fv is not None for fv in face_vns):
        vn = np.asarray(vns, np.float64)
        normals = vn[np.asarray(face_vns, np.int64)].mean(axis=1)
        n = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(n, 1e-30)
    return v, fc, normals
