"""Vehicle dynamics models of the port (counterpart of ``racing_lmpc_tpu.models``)."""

from racing_lmpc_torch.models.base import (
    BaseXIndex,
    BaseUIndex,
    VehicleModel,
    VehicleState,
    GRAVITY,
)
from racing_lmpc_torch.models.single_track import SingleTrackPlanarModel, SimpleUIndex
from racing_lmpc_torch.models.kinematic_bicycle import KinematicBicycleModel
from racing_lmpc_torch.models.double_track import DoubleTrackPlanarModel
from racing_lmpc_torch.models.factory import load_vehicle_model

__all__ = [
    "BaseXIndex",
    "BaseUIndex",
    "VehicleModel",
    "VehicleState",
    "GRAVITY",
    "SingleTrackPlanarModel",
    "SimpleUIndex",
    "KinematicBicycleModel",
    "DoubleTrackPlanarModel",
    "load_vehicle_model",
]
