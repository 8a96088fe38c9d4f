"""Model factory: string name -> model instance from a merged param tree.

Port of ``racing_lmpc_tpu/models/factory.py`` (parity target
``vehicle_model_factory.cpp:31-49``).
"""

from __future__ import annotations

from racing_lmpc_torch.config import (
    double_track_config_from_params,
    single_track_config_from_params,
    vehicle_config_from_params,
)
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.models.double_track import DoubleTrackPlanarModel
from racing_lmpc_torch.models.kinematic_bicycle import KinematicBicycleModel
from racing_lmpc_torch.models.single_track import SingleTrackPlanarModel


def load_vehicle_model(name: str, params: dict) -> VehicleModel:
    """Construct a model by name from a merged ROS parameter tree
    (see ``config.load_ros_params``)."""
    base = vehicle_config_from_params(params)
    if name == "kinematic_bicycle_model":
        # the kinematic loader reads the single_track_planar section
        # (kinematic_bicycle_model/src/ros_param_loader.cpp)
        return KinematicBicycleModel(base, single_track_config_from_params(params))
    if name == "single_track_planar_model":
        return SingleTrackPlanarModel(base, single_track_config_from_params(params))
    if name == "double_track_planar_model":
        return DoubleTrackPlanarModel(base, double_track_config_from_params(params))
    raise ValueError(f"unknown vehicle model: {name}")
