"""Frenet-frame track model of the port and the raceline map."""

from racing_lmpc_torch.track.trajectory import RacingTrajectory, TrajectoryIndex
from racing_lmpc_torch.track.trajectory_map import RacingTrajectoryMap

__all__ = ["RacingTrajectory", "RacingTrajectoryMap", "TrajectoryIndex"]
