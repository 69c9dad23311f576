from .force_model import ContactContext, ForceModel  # noqa: F401
from .hertz import (  # noqa: F401
    HertzianForceModel,
    HertzianFrictionlessForceModel,
)
from .prescriptions import FamilyChange, FamilyPrescription, fixed  # noqa: F401
