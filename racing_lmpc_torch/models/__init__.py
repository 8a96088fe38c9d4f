"""Vehicle dynamics models of the port (counterpart of ``racing_lmpc_tpu.models``)."""

from racing_lmpc_torch.models.base import BaseXIndex, BaseUIndex, VehicleModel, GRAVITY
from racing_lmpc_torch.models.single_track import SingleTrackPlanarModel, SimpleUIndex

__all__ = ["BaseXIndex", "BaseUIndex", "VehicleModel", "GRAVITY",
           "SingleTrackPlanarModel", "SimpleUIndex"]
