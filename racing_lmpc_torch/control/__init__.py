"""Controllers of the port: the batch-1 MPC controller cycle, the legacy
full-dynamics controller, PID and the pure-pursuit baseline."""

from racing_lmpc_torch.control.legacy_lmpc import (
    RacingLMPCLegacy, RacingLMPCLegacyConfig)
from racing_lmpc_torch.control.loop import (
    ControllerState, MPCController, RegressionSpec, StepInfo)
from racing_lmpc_torch.control.pid import PidCoefficients, PidController
from racing_lmpc_torch.control.telemetry import (
    CycleProfiler, Logger, LogLevel, Profile, ProfilerTrace)
from racing_lmpc_torch.control.vanilla import VanillaController, VanillaControllerConfig

__all__ = ["ControllerState", "MPCController", "RegressionSpec", "StepInfo",
           "CycleProfiler", "Logger", "LogLevel", "Profile", "ProfilerTrace",
           "PidController",
           "PidCoefficients", "RacingLMPCLegacy", "RacingLMPCLegacyConfig",
           "VanillaController", "VanillaControllerConfig"]
