from eebench.reference.models.base import KinematicModel, make_model
from eebench.reference.models.cart import Cart
from eebench.reference.models.omni import Omni

__all__ = ["KinematicModel", "make_model", "Cart", "Omni"]
