"""Control loop of the port: the batch-1 MPC controller cycle."""

from racing_lmpc_torch.control.loop import ControllerState, MPCController, StepInfo
from racing_lmpc_torch.control.telemetry import CycleProfiler, Profile

__all__ = ["ControllerState", "MPCController", "StepInfo", "CycleProfiler",
           "Profile"]
