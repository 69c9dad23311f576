"""Output writers (CSV tables, the npz binary format, meshes) and the
checkpoint readers.

Column names follow the JAX package's writers (``x,y,z,r,owner,absv,
family`` for spheres; ``x,y,z,clump_type,Qw..Qz,v_*,w_*,family`` for
clumps; ``A,B,contact_type,x,y,z,f_x,...`` for contacts); meshes go out
as legacy VTK polydata or Wavefront OBJ.

A numeric table is written with ``%.9g`` (``np.savetxt``), as the JAX
package's native writer does; a table with a non-numeric column (the
clump type's name) is written as the JAX package's ``csv`` path writes
it, byte for byte: ``repr`` of each float, ``str`` of anything else,
``\\r\\n`` line ends, but formatted column by column, not cell by cell
in a row loop.
"""

from __future__ import annotations

import csv
import operator
from typing import Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _cells(col: np.ndarray):
    """One (n,) column as a list of strings, as ``repr`` writes a float
    and ``str`` anything else."""
    vals = col.tolist()
    if col.dtype.kind == "f":
        return list(map(repr, vals))
    if col.dtype.kind == "O":
        return [repr(v) if isinstance(v, float) else str(v) for v in vals]
    return list(map(str, vals))


def write_csv(path, columns: Dict[str, np.ndarray]):
    keys = list(columns)
    n = len(np.asarray(columns[keys[0]]).reshape(-1)) if keys else 0
    cols = {k: np.asarray(v).reshape(n, -1) if n else np.zeros((0, 1))
            for k, v in columns.items()}
    header = []
    for k in keys:
        width = cols[k].shape[1]
        header += [k] if width == 1 else [f"{k}_{i}" for i in range(width)]
    if all(c.dtype.kind in "iubf" for c in cols.values()):
        data = (np.concatenate([c.astype(np.float64) for c in cols.values()],
                               axis=1) if keys else np.zeros((0, 0)))
        np.savetxt(path, data, fmt="%.9g", delimiter=",",
                   header=",".join(header), comments="")
        return
    cells = [_cells(c[:, j]) for c in cols.values()
             for j in range(c.shape[1])]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(zip(*cells))


def write_table(path, columns: Dict[str, np.ndarray], fmt="csv"):
    """Format dispatch of the Write*File family: "csv", or
    "binary"/"chpf"/"npz" for a compressed npz archive with the same
    column names (load with np.load)."""
    fmt = getattr(fmt, "value", fmt)
    if str(fmt).lower() in ("binary", "chpf", "npz"):
        # through a handle: np.savez_compressed appends '.npz' to a path
        with open(path, "wb") as f:
            np.savez_compressed(
                f, **{k: np.asarray(v) for k, v in columns.items()})
        return
    write_csv(path, columns)


def write_spheres_csv(path, pos, radius, owner=None, absv=None, family=None,
                      extra: Optional[Dict[str, np.ndarray]] = None,
                      fmt="csv"):
    cols = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2], "r": radius}
    if owner is not None:
        cols["owner"] = owner
    if absv is not None:
        cols["absv"] = absv
    if family is not None:
        cols["family"] = family
    cols.update(extra or {})
    write_table(path, cols, fmt)


def write_clumps_csv(path, pos, quat, vel=None, ang_vel=None, family=None,
                     clump_type=None,
                     extra: Optional[Dict[str, np.ndarray]] = None,
                     fmt="csv"):
    cols = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    if clump_type is not None:
        cols["clump_type"] = clump_type
    cols.update({"Qw": quat[:, 0], "Qx": quat[:, 1], "Qy": quat[:, 2],
                 "Qz": quat[:, 3]})
    if vel is not None:
        cols.update({"v_x": vel[:, 0], "v_y": vel[:, 1], "v_z": vel[:, 2]})
    if ang_vel is not None:
        cols.update({"w_x": ang_vel[:, 0], "w_y": ang_vel[:, 1],
                     "w_z": ang_vel[:, 2]})
    if family is not None:
        cols["family"] = family
    cols.update(extra or {})
    write_table(path, cols, fmt)


def write_contacts_csv(path, idA, idB, ctype, point=None, force=None,
                       torque=None, normal=None,
                       wildcards: Optional[Dict[str, np.ndarray]] = None,
                       fmt="csv"):
    cols = {"A": idA, "B": idB, "contact_type": ctype}
    if point is not None:
        cols.update({"x": point[:, 0], "y": point[:, 1], "z": point[:, 2]})
    if force is not None:
        cols.update({"f_x": force[:, 0], "f_y": force[:, 1],
                     "f_z": force[:, 2]})
    if torque is not None:
        cols.update({"tof_x": torque[:, 0], "tof_y": torque[:, 1],
                     "tof_z": torque[:, 2]})
    if normal is not None:
        cols.update({"n_x": normal[:, 0], "n_y": normal[:, 1],
                     "n_z": normal[:, 2]})
    for k, v in (wildcards or {}).items():
        cols[k] = v
    write_table(path, cols, fmt)


def write_mesh_vtk(path, vertices, faces, normals=None):
    """Legacy-VTK polydata mesh with per-facet normals as CELL_DATA."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    with open(path, "w") as out:
        out.write("# vtk DataFile Version 3.0\n")
        out.write("dem_engine_tpu mesh\nASCII\nDATASET POLYDATA\n")
        out.write(f"POINTS {len(v)} double\n")
        for p in v:
            out.write(f"{p[0]} {p[1]} {p[2]}\n")
        out.write(f"POLYGONS {len(f)} {4 * len(f)}\n")
        for tri in f:
            out.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
        if normals is not None:
            out.write(f"CELL_DATA {len(f)}\n")
            out.write("NORMALS facet_normals double\n")
            for p in np.asarray(normals, np.float64):
                out.write(f"{p[0]} {p[1]} {p[2]}\n")


def write_mesh_obj(path, vertices, faces, normals=None):
    """Wavefront OBJ mesh (SetMeshOutputFormat('obj')): one facet normal
    per face where given."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    with open(path, "w") as out:
        for p in v:
            out.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if normals is not None:
            for p in np.asarray(normals, np.float64):
                out.write(f"vn {p[0]} {p[1]} {p[2]}\n")
            for i, tri in enumerate(f):
                out.write(f"f {tri[0]+1}//{i+1} {tri[1]+1}//{i+1} "
                          f"{tri[2]+1}//{i+1}\n")
        else:
            for tri in f:
                out.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")


# ---------------------------------------------------------------------------
# checkpoint readers (the DEMSolver.Read*FromCsv static methods)
# ---------------------------------------------------------------------------


def _read_columns(path, names, defaults=None):
    """The named columns of a CSV file, each a list of its cells' strings,
    read row by row without keeping the other columns. A column the
    header lacks takes its entry of `defaults` on every row."""
    defaults = defaults or {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        where = {k: i for i, k in enumerate(header)}
        absent = [k for k in names if k not in where and k not in defaults]
        if absent:
            raise KeyError(f"{path}: no column {absent}")
        present = [k for k in names if k in where]
        get = operator.itemgetter(*(where[k] for k in present))
        rows = [get(r) for r in reader if r]
    if len(present) == 1:
        rows = [(r,) for r in rows]
    cols = dict(zip(present, map(list, zip(*rows)))) if rows else {
        k: [] for k in present}
    return {k: cols[k] if k in cols else [defaults[k]] * len(rows)
            for k in names}


def _floats(cells, dtype=np.float64):
    return np.fromiter(map(float, cells), np.float64, len(cells)).astype(
        dtype, copy=False)


def _by_type(path, columns):
    """{clump_type: (n, len(columns)) float64} of a clump file, the types
    in the order of their first row; a file without a clump_type column
    keys every row under ''."""
    c = _read_columns(path, ["clump_type", *columns], {"clump_type": ""})
    names = c["clump_type"]
    if not names:
        return {}
    vals = np.stack([_floats(c[k]) for k in columns], axis=1)
    uniq, first, inv = np.unique(np.asarray(names), return_index=True,
                                 return_inverse=True)
    inv = inv.reshape(-1)
    return {str(uniq[u]): vals[inv == u]
            for u in np.argsort(first, kind="stable")}


def read_clump_float3_from_csv(path, xcol, ycol, zcol):
    """{clump_type: (n, 3)} of any three columns of a clump file."""
    return _by_type(path, (xcol, ycol, zcol))


def read_clump_xyz_from_csv(path):
    """Returns {clump_type_name: (n,3) xyz}; unnamed types under ''."""
    return _by_type(path, ("x", "y", "z"))


def read_clump_quat_from_csv(path):
    return _by_type(path, ("Qw", "Qx", "Qy", "Qz"))


def read_clump_vel_from_csv(path):
    return _by_type(path, ("v_x", "v_y", "v_z"))


def read_clump_ang_vel_from_csv(path):
    return _by_type(path, ("w_x", "w_y", "w_z"))


def read_clump_template_csv(path):
    """Clump-template component file: x,y,z,r columns, '#' comment lines
    (the data/clumps format, read by LoadClumpType's file overload).
    Returns (radii (n,), relpos (n,3))."""
    radii, rel = [], []
    with open(path, newline="") as f:
        rows = csv.DictReader(
            line for line in f if not line.lstrip().startswith("#"))
        for row in rows:
            rel.append([float(row["x"]), float(row["y"]), float(row["z"])])
            radii.append(float(row["r"]))
    return np.asarray(radii), np.asarray(rel)


def read_contact_pairs_from_csv(path):
    """(idA, idB, contact_type) as int32; a file without a contact_type
    column reads as type 1 (sphere-sphere)."""
    c = _read_columns(path, ["A", "B", "contact_type"],
                      {"contact_type": "1"})

    def ints(cells):
        return np.fromiter(map(int, cells), np.int64, len(cells)).astype(
            np.int32)

    return ints(c["A"]), ints(c["B"]), ints(c["contact_type"])


def read_contact_wildcards_from_csv(path, names):
    c = _read_columns(path, list(names))
    return {n: _floats(c[n], np.float32) for n in names}
