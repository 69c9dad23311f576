"""The cohesive bed's contact force model, as a user's script writes it.

Hertz-Mindlin with friction history (the port's built-in callable), plus
``Cohesion * m_eff`` along -b2a while two bodies overlap, scaled by the
product of the two owners' wildcard ``coh_scale`` and of the spheres'
wildcard ``stick`` (a floor has no ``stick`` and counts 1).
"""

import torch

from dem_engine_tpu_torch import ForceModel
from dem_engine_tpu_torch.models.hertz import _full_fn

FRICTION_HISTORY = ("delta_tan_x", "delta_tan_y", "delta_tan_z", "delta_time")


def force_model():
    def fn(ctx):
        force, torque, wc = _full_fn(ctx)
        m_eff = ctx.a_mass * ctx.b_mass / torch.clamp(
            ctx.a_mass + ctx.b_mass, min=1e-30)
        scale = ctx.a_owner_wc["coh_scale"] * ctx.b_owner_wc["coh_scale"]
        scale = scale * ctx.a_geo_wc["stick"]
        if "stick" in ctx.b_geo_wc:
            scale = scale * ctx.b_geo_wc["stick"]
        f_coh = torch.where(ctx.overlap > 0.0,
                            ctx.pair("Cohesion") * m_eff * scale, 0.0)
        return force - f_coh[:, None] * ctx.b2a, torque, wc

    return ForceModel(
        name="hertz_cohesion", fn=fn, contact_wildcards=FRICTION_HISTORY,
        owner_wildcards=("coh_scale",), geo_wildcards=("stick",),
        per_material_props=("E", "nu"),
        pairwise_props=("CoR", "mu", "Crr", "Cohesion"))
