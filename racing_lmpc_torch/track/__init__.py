"""Frenet-frame track model of the port (host part)."""

from racing_lmpc_torch.track.trajectory import RacingTrajectory, TrajectoryIndex

__all__ = ["RacingTrajectory", "TrajectoryIndex"]
