"""dem_engine_tpu_torch: the DEM engine on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``dem_engine_tpu`` (JAX), which stays the reference. Users
drive it through ``DEMSolver`` (clumps of spheres on analytical
boundaries and triangle meshes, the built-in Hertz models and custom
force models with wildcards, persistent and restart contacts, family
prescriptions and rules, contact detection every K steps; inspectors,
clump and contact files, stage timing),
which runs ``solver.Engine.advance``. On a CUDA device its kernels
(``csrc/``) do the SS force pass (with its unique-fetch and query
variants), the owner wrench sums and the SS pair search; on the CPU
their plain PyTorch versions run. Entry points run on the card unless
the caller passes ``device="cpu"``. The package never imports JAX.
"""

from .api import (  # noqa: F401
    BoxRegion,
    DEMInspector,
    DEMSolver,
    DEMTracker,
    SphereRegion,
)
from .cases import build_case  # noqa: F401
from .defines import (  # noqa: F401
    ContactOutputContent,
    OutputContent,
    TimeIntegrator,
    Verbosity,
)
from .models import (  # noqa: F401
    FamilyChange,
    FamilyPrescription,
    HertzianForceModel,
    HertzianFrictionlessForceModel,
)
from .solver import Engine, dynamics_step, refresh_contacts  # noqa: F401
from .state import SimState, SolverConfig  # noqa: F401
from .structs import (  # noqa: F401
    DEMClumpBatch,
    DEMClumpTemplate,
    DEMExternObj,
    DEMMaterial,
    DEMMeshConnected,
)
from .utils.samplers import (  # noqa: F401
    DEMBoxGridSampler,
    DEMBoxHCPSampler,
    DEMCylSurfSampler,
    GridSampler,
    HCPSampler,
    PDSampler,
)

__version__ = "0.2.0"
