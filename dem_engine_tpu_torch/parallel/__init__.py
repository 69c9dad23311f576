"""Multi-device runs over ``torch.distributed``: ``mesh`` lays the solver
state over a 1-D process group (NCCL on the card, gloo on the CPU) and
``spatial`` is the x-slab sphere-sphere search. ``solver.Engine(cfg,
mesh)`` drives both."""

from .mesh import (Layout, Mesh, gather_state, make_mesh, shard_state,
                   state_shardings)
from .spatial import find_pairs_ss_spatial

__all__ = ["Layout", "Mesh", "find_pairs_ss_spatial", "gather_state",
           "make_mesh", "shard_state", "state_shardings"]
