"""Launch scenarios of the port: the in-process co-simulation runners."""

from racing_lmpc_torch.launch.runner import (
    CoSimulation,
    ContinuousCoSimulation,
    ScenarioSpec,
    sim_barc_lmpc,
    sim_barc_tracking_mpc,
    sim_putnam_config_a_tracking_mpc,
    sim_putnam_short_lmpc,
    sim_putnam_short_tracking_mpc,
)

__all__ = ["CoSimulation", "ContinuousCoSimulation", "ScenarioSpec",
           "sim_barc_lmpc", "sim_barc_tracking_mpc", "sim_putnam_short_lmpc",
           "sim_putnam_short_tracking_mpc", "sim_putnam_config_a_tracking_mpc"]
