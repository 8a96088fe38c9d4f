"""Plant simulator of the port."""

from racing_lmpc_torch.sim.simulator import RacingSimulator

__all__ = ["RacingSimulator"]
