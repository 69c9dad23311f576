"""Force-model protocol over tensors.

A force model is a Python callable over batched tensors. It receives a
``ContactContext`` with the contact's ingredients (overlap, normal,
contact point, kinematics, mixed material properties, wildcards, time
step) and returns the force on body A, a torque-only force and the
updated per-contact wildcards. All fields are batched over the table's
capacity axis; the engine masks padding rows after the model runs, so a
model may compute garbage there as long as it is finite.

A model's callable computes with torch operations on the context's
tensors (``torch.where``, ``torch.sqrt``); it must not read back to the
host (``.item()``, ``float(x)``, ``x[mask]``), since the step runs it
with no sync. The built-in Hertz callables (``models.hertz._full_fn``,
``_frictionless_fn``) are building blocks a custom model may call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass
class ContactContext:
    # geometry
    overlap: torch.Tensor       # f32[C] penetration depth (<0 within margin)
    b2a: torch.Tensor           # f32[C,3] unit normal, B -> A
    cp_a: torch.Tensor          # f32[C,3] contact point rel owner-A CoM
    cp_b: torch.Tensor          # f32[C,3] contact point rel owner-B CoM
    a_radius: torch.Tensor      # f32[C]
    b_radius: torch.Tensor      # f32[C] (HUGE for tri/analytical)
    contact_type: torch.Tensor  # i32[C]
    # kinematics
    a_lin_vel: torch.Tensor     # f32[C,3] global
    b_lin_vel: torch.Tensor
    a_rot_vel: torch.Tensor     # f32[C,3] body frame
    b_rot_vel: torch.Tensor
    a_quat: torch.Tensor        # f32[C,4]
    b_quat: torch.Tensor
    # mass properties
    a_mass: torch.Tensor        # f32[C]
    b_mass: torch.Tensor
    a_moi: torch.Tensor         # f32[C,3]
    b_moi: torch.Tensor
    # identity
    a_owner: torch.Tensor       # i32[C]
    b_owner: torch.Tensor
    a_geo: torch.Tensor         # i32[C]
    b_geo: torch.Tensor
    a_family: torch.Tensor      # i32[C]
    b_family: torch.Tensor
    a_mat: torch.Tensor         # i32[C]
    b_mat: torch.Tensor
    # state
    time: torch.Tensor          # f32[]
    ts: torch.Tensor            # f32[] step size
    # wildcards
    wildcards: Dict[str, torch.Tensor]
    a_geo_wc: Dict[str, torch.Tensor]
    b_geo_wc: Dict[str, torch.Tensor]
    a_owner_wc: Dict[str, torch.Tensor]
    b_owner_wc: Dict[str, torch.Tensor]
    # material tables
    mat_props: Dict[str, torch.Tensor]      # f32[M]
    pair_props: Dict[str, torch.Tensor]     # f32[M,M]
    premix: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def mat(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-material property for (A, B)."""
        a = self.premix.get(name + ":a")
        if a is not None:
            return a, self.premix[name + ":b"]
        tab = self.mat_props[name]
        return tab[self.a_mat], tab[self.b_mat]

    def pair(self, name: str) -> torch.Tensor:
        """Pairwise-mixed property for the (A, B) material pair."""
        p = self.premix.get(name)
        if p is not None:
            return p
        return self.pair_props[name][self.a_mat, self.b_mat]

    def rot_vel_cp_global(self):
        """Contact-point rotational velocities of A and B, global frame:
        R(q) (omega_body x cp_local)."""
        from ..ops import quat as q

        lcp_a = q.rotate_inv(self.a_quat, self.cp_a)
        lcp_b = q.rotate_inv(self.b_quat, self.cp_b)
        va = q.rotate(self.a_quat, q.cross(self.a_rot_vel, lcp_a))
        vb = q.rotate(self.b_quat, q.cross(self.b_rot_vel, lcp_b))
        return va, vb


ForceFn = Callable[[ContactContext], Tuple[torch.Tensor, torch.Tensor, Dict]]


@dataclasses.dataclass(frozen=True, eq=False)
class ForceModel:
    """A force model and its declared resources. ``fused_variant`` names
    the hand-written fused SS kernel variant of the built-in Hertz models
    ("hertz_full" / "hertz_frictionless"); a model without one runs
    ``forces.contact_pass`` on every table. The setters that change what
    the model reads per contact (material props, contact wildcards) drop
    the fused variant, as the JAX package's do."""

    name: str
    fn: ForceFn
    contact_wildcards: Tuple[str, ...] = ()
    owner_wildcards: Tuple[str, ...] = ()
    geo_wildcards: Tuple[str, ...] = ()
    per_material_props: Tuple[str, ...] = ("E", "nu")
    pairwise_props: Tuple[str, ...] = ("CoR", "mu", "Crr")
    # True where the model acts without overlap (within the family extra
    # margin), e.g. electrostatics: a declaration only, the engine runs
    # such a model as any other
    no_contact_force: bool = False
    fused_variant: str | None = None

    def __hash__(self):
        return id(self)

    def SetMustHaveMatProp(self, names):
        object.__setattr__(self, "per_material_props", tuple(names))
        object.__setattr__(self, "fused_variant", None)

    def SetMustPairwiseMatProp(self, names):
        object.__setattr__(self, "pairwise_props", tuple(names))
        object.__setattr__(self, "fused_variant", None)

    def SetPerContactWildcards(self, names):
        object.__setattr__(self, "contact_wildcards", tuple(sorted(names)))
        object.__setattr__(self, "fused_variant", None)

    def SetPerOwnerWildcards(self, names):
        object.__setattr__(self, "owner_wildcards", tuple(sorted(names)))

    def SetPerGeometryWildcards(self, names):
        object.__setattr__(self, "geo_wildcards", tuple(sorted(names)))


def effective_mass(ctx: ContactContext) -> torch.Tensor:
    return ctx.a_mass * ctx.b_mass / (ctx.a_mass + ctx.b_mass)


def effective_radius(ctx: ContactContext) -> torch.Tensor:
    return ctx.a_radius * ctx.b_radius / (ctx.a_radius + ctx.b_radius)


def hertz_material_mix(E_a, nu_a, E_b, nu_b):
    """Effective Young's and shear moduli of the pair."""
    inv_E = (1.0 - nu_a * nu_a) / E_a + (1.0 - nu_b * nu_b) / E_b
    inv_G = (
        2.0 * (2.0 - nu_a) * (1.0 + nu_a) / E_a
        + 2.0 * (2.0 - nu_b) * (1.0 + nu_b) / E_b
    )
    return 1.0 / inv_E, 1.0 / inv_G
