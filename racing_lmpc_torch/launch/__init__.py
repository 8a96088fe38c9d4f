"""Launch scenarios of the port: the in-process co-simulation runners."""

from racing_lmpc_torch.launch.runner import CoSimulation, ScenarioSpec

__all__ = ["CoSimulation", "ScenarioSpec"]
