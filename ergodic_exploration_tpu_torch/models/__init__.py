from ergodic_exploration_tpu_torch.models.base import KinematicModel, make_model
from ergodic_exploration_tpu_torch.models.cart import Cart
from ergodic_exploration_tpu_torch.models.omni import Omni

__all__ = ["KinematicModel", "make_model", "Cart", "Omni"]
