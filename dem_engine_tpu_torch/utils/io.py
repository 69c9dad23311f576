"""Output writers: CSV tables and the npz binary format.

Column names follow the JAX package's writers (``x,y,z,r,owner,absv,
family`` for spheres; ``A,B,contact_type,x,y,z,f_x,...`` for contacts).
A numeric table is written with ``%.9g``, as the JAX package's native
writer does; a table with non-numeric columns goes through ``csv``.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np


def write_csv(path, columns: Dict[str, np.ndarray]):
    keys = list(columns)
    n = len(np.asarray(columns[keys[0]]).reshape(-1)) if keys else 0
    cols = {k: np.asarray(v).reshape(n, -1) if n else np.zeros((0, 1))
            for k, v in columns.items()}
    header = []
    for k in keys:
        width = cols[k].shape[1]
        header += [k] if width == 1 else [f"{k}_{i}" for i in range(width)]
    if all(np.issubdtype(c.dtype, np.number) or c.dtype == bool
           for c in cols.values()):
        data = (np.concatenate([c.astype(np.float64) for c in cols.values()],
                               axis=1) if keys else np.zeros((0, 0)))
        np.savetxt(path, data, fmt="%.9g", delimiter=",",
                   header=",".join(header), comments="")
        return
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(n):
            row = []
            for k in keys:
                for x in cols[k][i]:
                    v = x.item() if hasattr(x, "item") else x
                    row.append(repr(v) if isinstance(v, float) else str(v))
            w.writerow(row)


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
