from . import se3, so3
from .se3 import Pose

__all__ = ["se3", "so3", "Pose"]
