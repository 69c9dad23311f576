"""Constants and enums of the PyTorch/CUDA port.

Same values as ``dem_engine_tpu.defines``: contact and analytical type
codes, the reserved and default families, the integrator, verbosity and
output enums, and the solver defaults.
Device-visible ids stay int32, so a state carried across from the JAX
package keeps its dtypes.
"""

from __future__ import annotations

import enum

import torch

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------
F = torch.float32
I = torch.int32

# ---------------------------------------------------------------------------
# contact types
# ---------------------------------------------------------------------------
NOT_A_CONTACT = 0
SPHERE_SPHERE_CONTACT = 1
SPHERE_MESH_CONTACT = 2
SPHERE_ANALYTICAL_CONTACT = 10
SPHERE_PLANE_CONTACT = 11
SPHERE_PLATE_CONTACT = 12
SPHERE_CYL_CONTACT = 13
SPHERE_CONE_CONTACT = 14
SPHERE_BOX_CONTACT = 15

# analytical object type codes
ANAL_PLANE = 0
ANAL_PLATE = 1
ANAL_CYL_INF = 2
ANAL_CONE = 3
ANAL_BOX = 4

# entity normal direction as the narrow-phase sign convention
ENTITY_NORMAL_INWARD = 1.0
ENTITY_NORMAL_OUTWARD = -1.0

# ---------------------------------------------------------------------------
# families: 255 is reserved as always-fixed
# ---------------------------------------------------------------------------
NUM_FAMILIES = 256
RESERVED_FAMILY = NUM_FAMILIES - 1
DEFAULT_FAMILY = 0


class TimeIntegrator(enum.Enum):
    """Velocity pass-on policy of the explicit integrator."""

    FORWARD_EULER = "forward_euler"
    CENTERED_DIFFERENCE = "centered_difference"
    EXTENDED_TAYLOR = "extended_taylor"


class Verbosity(enum.IntEnum):
    QUIET = 0
    ERROR = 10
    WARNING = 20
    INFO = 30
    STEP_ANOMALY = 32
    STEP_METRIC = 35
    DEBUG = 40
    STEP_DEBUG = 50


class OutputContent(enum.Flag):
    """Clump-output columns."""

    XYZ = enum.auto()
    QUAT = enum.auto()
    ABSV = enum.auto()
    VEL = enum.auto()
    ANG_VEL = enum.auto()
    ABS_ACC = enum.auto()
    ACC = enum.auto()
    ANG_ACC = enum.auto()
    FAMILY = enum.auto()
    MAT = enum.auto()
    OWNER_WILDCARD = enum.auto()
    GEO_WILDCARD = enum.auto()
    EXP_FACTOR = enum.auto()


class OutputFormat(enum.Enum):
    """File format of the Write*File family: CSV, or compressed .npz
    column archives for BINARY/CHPF."""

    CSV = "csv"
    BINARY = "binary"
    CHPF = "chpf"


class ContactOutputContent(enum.Flag):
    CNT_TYPE = enum.auto()
    FORCE = enum.auto()
    POINT = enum.auto()
    COMPONENT = enum.auto()
    NORMAL = enum.auto()
    TORQUE = enum.auto()
    CNT_WILDCARD = enum.auto()
    OWNER = enum.auto()
    GEO_ID = enum.auto()
    NICKNAME = enum.auto()


# ---------------------------------------------------------------------------
# solver defaults
# ---------------------------------------------------------------------------
DEFAULT_UPDATE_FREQ = 20
DEFAULT_EXPAND_SAFETY_MULTI = 1.0
DEFAULT_EXPAND_SAFETY_ADDER = 0.0
DEFAULT_ERROR_OUT_VEL = 5e4
DEFAULT_ERROR_OUT_AVG_CONTACTS = 100.0
TINY_FLOAT = 1e-12
HUGE_FLOAT = 1e30

__all__ = [name for name in dir() if not name.startswith("_")]
