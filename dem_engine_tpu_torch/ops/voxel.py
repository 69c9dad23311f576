"""Voxel + in-voxel float coordinate scheme.

An int32 voxel index per axis plus a float32 offset inside the voxel, so
relative positions of nearby bodies are exact in the integer part:

    rel = (vox_a - vox_b) * voxel_size + (loc_a - loc_b)        (all f32)

Positions are relative to the domain's lower-bottom-front corner.
"""

from __future__ import annotations

import numpy as np
import torch

from ..defines import F, I


#: voxels along the largest domain extent: |vox_a - vox_b| * voxel_size
#: stays exact in f32 and i32 keeps headroom
DEFAULT_VOXELS_PER_AXIS = 1 << 20


def choose_voxel_size(domain_extents) -> float:
    """The voxel size at which the largest extent spans
    DEFAULT_VOXELS_PER_AXIS voxels."""
    return float(np.max(np.asarray(domain_extents, dtype=np.float64))) / (
        DEFAULT_VOXELS_PER_AXIS)


def encode(pos, voxel_size):
    """Split LBF-relative f32 positions into (vox, loc)."""
    vox = torch.floor(pos / voxel_size).to(I)
    loc = (pos - vox.to(pos.dtype) * voxel_size).to(F)
    return vox, loc


def encode_host(pos, voxel_size):
    """Exact host-side (numpy, float64) encode for initialization."""
    pos = np.asarray(pos, dtype=np.float64)
    vox = np.floor(pos / voxel_size).astype(np.int32)
    loc = (pos - vox.astype(np.float64) * voxel_size).astype(np.float32)
    return vox, loc


def decode_host(vox, loc, voxel_size):
    """Exact host-side decode to float64 LBF-relative positions."""
    return np.asarray(vox, dtype=np.float64) * float(voxel_size) + np.asarray(
        loc, dtype=np.float64
    )


def decode_f32(vox, loc, voxel_size):
    """Approximate f32 absolute position, for binning and margins."""
    return vox.to(F) * voxel_size + loc


def advance(vox, loc, disp, voxel_size):
    """Move by f32 displacement `disp`, renormalizing loc into [0, vs)."""
    loc = loc + disp
    shift = torch.floor(loc / voxel_size)
    vox = vox + shift.to(I)
    loc = loc - shift * voxel_size
    return vox, loc


def rel_pos(vox_a, loc_a, vox_b, loc_b, voxel_size):
    """Position of A relative to B in f32: exact int diff + local f32 diff."""
    return (vox_a - vox_b).to(F) * voxel_size + (loc_a - loc_b)
