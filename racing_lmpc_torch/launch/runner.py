"""In-process co-simulation of the reference's launch scenarios.

Port of ``racing_lmpc_tpu/launch/runner.py`` (``ScenarioSpec``, the five
``_SCENARIOS``, ``CoSimulation``, ``ContinuousCoSimulation``, the ``sim_*``
factories and the command line; parity target
``racing_lmpc_launch/launch/{barc,putnam}/*.launch.py``): a simulator in
the global frame and an MPC controller in the Frenet frame, exchanging the
reference's messages in lock step ("step" co-simulation mode) or on a
simulated clock (continuous mode), with the per-step global <-> Frenet
conversions of the two nodes (racing_simulator_node.cpp:266-284,
racing_mpc_node.cpp:180-186).  The controller and the plant run on one
device (CUDA unless the caller names one); the state message and its
Frenet projection are built on the host.

Run e.g.:  python -m racing_lmpc_torch.launch.runner barc_lmpc --steps 400

Not ported yet: ``BusCoSimulation`` (it needs the native bus).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import (
    PARAM_DIR, SS_DIR, TRACK_DIR, SimulatorConfig, load_ros_params,
    mpc_config_from_params, single_track_config_from_params,
    vehicle_config_from_params)
from racing_lmpc_torch.control.loop import MPCController
from racing_lmpc_torch.control.telemetry import CycleProfiler
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.msgs import MPCTelemetry, VehicleActuationMsg, VehicleStateMsg
from racing_lmpc_torch.sim import RacingSimulator
from racing_lmpc_torch.track import RacingTrajectory, RacingTrajectoryMap


@dataclass
class ScenarioSpec:
    name: str
    vehicle_base_yaml: str
    vehicle_model_yaml: str
    mpc_yaml: str
    track_dir: str
    sim_track_file: str
    default_traj_idx: int
    x0_global: tuple
    dt: float = 0.025
    velocity_profile_scale: float = 1.0
    delay_step: int | None = None   # None = the MPC config / mode default
    n_override: int | None = None
    load_laps: tuple = ()
    mpc_extra: dict = field(default_factory=dict)


# the five shipped launch scenarios, as the reference defines them
# (racing_lmpc_tpu/launch/runner.py:69-139, which gives the reasons for the
# Putnam LMPC's laps, elastic state boxes and SQP re-linearization)
_SCENARIOS = {
    "barc_lmpc": ScenarioSpec(
        name="barc_lmpc",
        vehicle_base_yaml="barc_base.param.yaml",
        vehicle_model_yaml="barc_single_track.param.yaml",
        mpc_yaml="barc_lmpc.param.yaml",
        track_dir="barc", sim_track_file="barc/02_barc_center.txt",
        default_traj_idx=2,
        x0_global=(1.0, 0.0, 0.0, 1.5, 0.0, 0.0),
        velocity_profile_scale=0.9,
        load_laps=tuple(str(SS_DIR / "barc" / f"ss_lap_{i}") for i in (1, 2, 3)),
    ),
    "barc_tracking_mpc": ScenarioSpec(
        name="barc_tracking_mpc",
        vehicle_base_yaml="barc_base.param.yaml",
        vehicle_model_yaml="barc_single_track.param.yaml",
        mpc_yaml="barc_tracking_mpc.param.yaml",
        track_dir="barc", sim_track_file="barc/02_barc_center.txt",
        default_traj_idx=2,
        x0_global=(1.0, 0.0, 0.0, 1.5, 0.0, 0.0),
        velocity_profile_scale=0.9,
    ),
    "putnam_short_lmpc": ScenarioSpec(
        name="putnam_short_lmpc",
        vehicle_base_yaml="iac_car_base.param.yaml",
        vehicle_model_yaml="iac_car_single_track.param.yaml",
        mpc_yaml="iac_car_lmpc.param.yaml",
        track_dir="putnam_short",
        sim_track_file="putnam_short/08_putnam_short_optm.txt",
        default_traj_idx=8,
        x0_global=(-10.0, 2.0, 3.14, 10.0, 0.0, 0.0),
        dt=0.1,
        load_laps=tuple(str(SS_DIR / "putnam_short" / f"ss_lap_{i}")
                        for i in (1, 2, 3)),
        mpc_extra={"q_state_slack": 2000.0, "sqp_relin_steps": 3},
    ),
    "putnam_short_tracking_mpc": ScenarioSpec(
        name="putnam_short_tracking_mpc",
        vehicle_base_yaml="iac_car_base.param.yaml",
        vehicle_model_yaml="iac_car_single_track.param.yaml",
        mpc_yaml="iac_car_tracking_mpc.param.yaml",
        track_dir="putnam_short",
        sim_track_file="putnam_short/08_putnam_short_optm.txt",
        default_traj_idx=8,
        x0_global=(-10.0, 2.0, 3.14, 15.0, 0.0, 0.0),
    ),
    "putnam_config_a_tracking_mpc": ScenarioSpec(
        name="putnam_config_a_tracking_mpc",
        vehicle_base_yaml="iac_car_base.param.yaml",
        vehicle_model_yaml="iac_car_single_track.param.yaml",
        mpc_yaml="iac_car_tracking_mpc.param.yaml",
        track_dir="putnam", sim_track_file="putnam/10_putnam_optm.txt",
        default_traj_idx=10,
        x0_global=(-10.0, 2.0, 3.14, 15.0, 0.0, 0.0),
    ),
}


class CoSimulation:
    """Lock-step simulator + controller, the in-process equivalent of the
    two-node launch ("step" co-simulation mode)."""

    def __init__(self, spec: ScenarioSpec, n_override: int | None = None,
                 mpc_overrides: dict | None = None, device=None):
        self.spec = spec
        device = resolve_device(device)
        params = load_ros_params(PARAM_DIR / spec.vehicle_base_yaml,
                                 PARAM_DIR / spec.vehicle_model_yaml)
        base = vehicle_config_from_params(params)
        st = single_track_config_from_params(params)
        # the simulator's model runs in the global frame (launch: use_frenet
        # False)
        base_global = dataclasses.replace(
            base, modeling=dataclasses.replace(base.modeling, use_frenet=False))
        self.sim_model = SingleTrackPlanarModel(base_global, st)
        self.ctrl_model = SingleTrackPlanarModel(base, st)

        self.track = RacingTrajectory.from_file(TRACK_DIR / spec.sim_track_file,
                                                device=device)
        self.track_map = RacingTrajectoryMap(TRACK_DIR / spec.track_dir, device=device)

        overrides = {**spec.mpc_extra, **(mpc_overrides or {})}
        if spec.load_laps:
            overrides.setdefault("load", True)
            overrides.setdefault("load_path", spec.load_laps)
        if n_override:
            overrides["n"] = n_override
        overrides.setdefault("step_mode", "step")
        mpc_cfg = mpc_config_from_params(
            load_ros_params(PARAM_DIR / spec.mpc_yaml), **overrides)

        self.controller = MPCController(mpc_cfg, self.ctrl_model, self.track,
                                        spec.dt, device=device)
        self.controller.speed_scale = spec.velocity_profile_scale
        if spec.delay_step is not None:
            self.controller.delay_step = spec.delay_step

        self.simulator = RacingSimulator(
            SimulatorConfig(dt=spec.dt, x0=spec.x0_global, step_mode="step"),
            self.sim_model, self.track, device=device)

        self.profiler = CycleProfiler(capacity=40)
        self.telemetry: list[MPCTelemetry] = []
        self.lap_times: list[float] = []
        self._lap_start_t = 0.0
        self._t = 0.0
        self._last_s = None
        self._s_prev_seed = None
        self._u_prev = np.zeros((self.ctrl_model.nu,), dtype=np.float32)
        self.lap_num = 0
        # optional hook mapping the published state message to the one the
        # controller consumes (the seam of a state estimator)
        self.state_filter = None

    # ------------------------------------------------------------------
    def vehicle_state_msg(self) -> VehicleStateMsg:
        """Global sim state -> VehicleStateMsg with parametric pose and
        velocity (racing_simulator_node update_vehicle_state_msg,
        :203-238): one device pull for the state, the Frenet bookkeeping on
        the host spline twins."""
        x = self.simulator.x.cpu().numpy()
        pf = self.track.global_to_frenet_np(
            x[:3].astype(np.float64), s_prev=self._s_prev_seed)
        self._s_prev_seed = float(pf[0])
        msg = VehicleStateMsg(t=self._t)
        msg.x.x, msg.x.y = float(x[0]), float(x[1])
        msg.e.psi = float(x[2])
        msg.v.v_long, msg.v.v_tran = float(x[3]), float(x[4])
        msg.w.w_psi = float(x[5])
        msg.p.s, msg.p.x_tran, msg.p.e_psi = map(float, pf)
        k = float(self.track.curvature_np(pf[0]))
        msg.pt.ds = float(
            (x[3] * np.cos(pf[2]) - x[4] * np.sin(pf[2])) / (1.0 - pf[1] * k))
        msg.pt.dx_tran = float(x[3] * np.sin(pf[2]) + x[4] * np.cos(pf[2]))
        msg.pt.de_psi = float(x[5] - k * msg.pt.ds)
        msg.lap_num = float(self.lap_num)
        return msg

    def controller_cycle(self, msg: VehicleStateMsg) -> VehicleActuationMsg:
        """Controller node half: VehicleStateMsg -> solve -> actuation
        (racing_mpc_node on_step_timer, :150-477).  ``solve_time`` ends
        with the one device-to-host copy of what the cycle publishes, so it
        covers the whole cycle on the device."""
        if self.state_filter is not None:
            msg = self.state_filter(msg)
        x_frenet = np.asarray([msg.p.s, msg.p.x_tran, msg.p.e_psi,
                               msg.v.v_long, msg.v.v_tran, msg.w.w_psi],
                              dtype=np.float32)
        nu = self.ctrl_model.nu
        t0 = time.perf_counter()
        info = self.controller.step(x_frenet, u_ic=self._u_prev)
        host = torch.cat([info.u_base, info.u_apply, info.output.obj[None],
                          info.output.X_optm[0],
                          info.used_fallback[None].float()]).cpu().numpy()
        solve_time = time.perf_counter() - t0
        u_base, u_apply = host[:3], host[3:3 + nu]
        obj, x0, fb = host[3 + nu], host[4 + nu:-1], bool(host[-1])
        self.profiler.add_cycle_stats(solve_time)
        self._u_prev = u_apply

        # actuation: dominant-force sign split (racing_mpc_node.cpp:396-402)
        u_a = u_base[0] if abs(u_base[0]) > abs(u_base[1]) else u_base[1]
        act = VehicleActuationMsg(t=self._t, u_a=float(u_a), u_steer=float(u_base[2]))
        self.telemetry.append(MPCTelemetry(
            trajectory_index=self.spec.default_traj_idx, solved=not fb,
            cost=float(obj), state=[float(v) for v in x0],
            control=[float(v) for v in u_apply], solve_time=solve_time))
        return act

    def plant_cycle(self, act: VehicleActuationMsg) -> VehicleStateMsg:
        """Simulator node half: actuation -> plant step -> next state msg
        (racing_simulator_node on_state_update, :240-332)."""
        # the simulator splits u_a back by sign (racing_simulator_node.cpp:249-254)
        self.simulator.step([max(act.u_a, 0.0), min(act.u_a, 0.0), act.u_steer])
        msg = self.vehicle_state_msg()
        # lap counting by abscissa wrap (racing_simulator_node.cpp:266-284)
        s_now = msg.p.s
        if self._last_s is not None and self._last_s - s_now > 0.5 * self.track.total_length:
            self.lap_num += 1
            if self._lap_start_t > 0.0 or self.lap_num > 1:
                self.lap_times.append(self._t - self._lap_start_t)
            self._lap_start_t = self._t
        self._last_s = s_now
        self._t += self.spec.dt
        return msg

    def step(self) -> MPCTelemetry:
        """One lock-step cycle: state -> MPC -> actuation -> plant."""
        self.plant_cycle(self.controller_cycle(self.vehicle_state_msg()))
        return self.telemetry[-1]

    def run(self, steps: int, log_every: int = 0) -> dict:
        for i in range(steps):
            tel = self.step()
            if log_every and i % log_every == 0:
                print(f"[{i:5d}] t={self._t:7.2f}s lap={self.lap_num} "
                      f"s={self._last_s:7.2f} solved={tel.solved} "
                      f"solve={tel.solve_time * 1e3:6.1f}ms")
        prof = self.profiler.profile()
        return {
            "laps": self.lap_num,
            "lap_times": self.lap_times,
            "fallback_rate": float(np.mean([not t.solved for t in self.telemetry])),
            "solve_time": {"min": prof.min, "mean": prof.mean, "max": prof.max},
            "diagnostics": prof.to_diagnostic_status(
                f"{self.spec.name} MPC Solve Time", "s", self.spec.dt),
        }

    def export_telemetry(self, path: str | Path):
        Path(path).write_text(json.dumps([t.to_dict() for t in self.telemetry]))


class ContinuousCoSimulation:
    """Continuous-mode co-simulation on a simulated clock
    (``runner.py:313-398``).

    The reference's continuous mode runs both nodes on timers: the simulator
    integrates and publishes ``vehicle_state`` every sim tick, and keeps
    publishing when no actuation arrives (racing_simulator_node.cpp:125-129
    and the keepalive :172-189), while the MPC node solves on its own period
    and compensates the actuation delay (x_ic advanced one step with the
    in-flight command, ``u[delay_step]`` applied; racing_mpc_node.cpp:
    114-118,386-402).  Here one plant tick runs every ``sim_dt`` (0.01 s,
    continuous_simulator.param.yaml) and one controller cycle whenever the
    simulated clock reaches the next multiple of ``spec.dt`` (an
    accumulator: 25 ms over 10 ms ticks), its command taking effect on the
    next tick.  ``actuation_gate(t) -> bool`` simulates actuation loss:
    while it is False the command is dropped and the plant keeps flying the
    last one.
    """

    def __init__(self, spec: ScenarioSpec, sim_dt: float = 0.01,
                 n_override: int | None = None, mpc_overrides: dict | None = None,
                 device=None):
        ov = dict(mpc_overrides or {})
        ov["step_mode"] = "continuous"
        self.cs = CoSimulation(spec, n_override=n_override, mpc_overrides=ov,
                               device=device)
        self.sim_dt = sim_dt
        self.ctrl_dt = spec.dt
        self._next_ctrl_t = 0.0
        # the continuous-mode delay pick (1) comes from the config's -1
        # (auto); an explicit config value is honoured as it is
        self.cs.simulator = RacingSimulator(
            SimulatorConfig(dt=sim_dt, x0=spec.x0_global, step_mode="continuous"),
            self.cs.sim_model, self.cs.track, device=self.cs.simulator.device)
        self.act: VehicleActuationMsg | None = None
        self.published: list[VehicleStateMsg] = []
        self._tick = 0

    def _plant_tick(self) -> VehicleStateMsg:
        """One sim integration + state publish at the sim rate
        (racing_simulator_node.cpp:240-332, lap counting :266-284)."""
        cs = self.cs
        act = self.act or VehicleActuationMsg(t=cs._t, u_a=0.0, u_steer=0.0)
        cs.simulator.step([max(act.u_a, 0.0), min(act.u_a, 0.0), act.u_steer])
        msg = cs.vehicle_state_msg()
        s_now = msg.p.s
        if cs._last_s is not None and cs._last_s - s_now > 0.5 * cs.track.total_length:
            cs.lap_num += 1
            if cs._lap_start_t > 0.0 or cs.lap_num > 1:
                cs.lap_times.append(cs._t - cs._lap_start_t)
            cs._lap_start_t = cs._t
        cs._last_s = s_now
        cs._t += self.sim_dt
        self.published.append(msg)
        return msg

    def run(self, sim_steps: int, actuation_gate=None) -> dict:
        cs = self.cs
        msg = cs.vehicle_state_msg()
        for _ in range(sim_steps):
            if cs._t >= self._next_ctrl_t - 1e-9:
                self._next_ctrl_t += self.ctrl_dt
                act = cs.controller_cycle(msg)
                if actuation_gate is None or actuation_gate(cs._t):
                    self.act = act
                # else: actuation lost; the plant keeps flying the last
                # command and keeps publishing (keepalive)
            msg = self._plant_tick()
            self._tick += 1
        prof = cs.profiler.profile()
        return {
            "laps": cs.lap_num,
            "lap_times": cs.lap_times,
            "published_states": len(self.published),
            "controller_cycles": len(cs.telemetry),
            "fallback_rate": float(np.mean(
                [not t.solved for t in cs.telemetry])) if cs.telemetry else 0.0,
            "solve_time": {"min": prof.min, "mean": prof.mean, "max": prof.max},
        }


def _make(name: str, **kw) -> CoSimulation:
    return CoSimulation(_SCENARIOS[name], **kw)


def sim_barc_lmpc(**kw) -> CoSimulation:
    return _make("barc_lmpc", **kw)


def sim_barc_tracking_mpc(**kw) -> CoSimulation:
    return _make("barc_tracking_mpc", **kw)


def sim_putnam_short_lmpc(**kw) -> CoSimulation:
    return _make("putnam_short_lmpc", **kw)


def sim_putnam_short_tracking_mpc(**kw) -> CoSimulation:
    return _make("putnam_short_tracking_mpc", **kw)


def sim_putnam_config_a_tracking_mpc(**kw) -> CoSimulation:
    return _make("putnam_config_a_tracking_mpc", **kw)


def main(argv=None):
    """The runner's command line (``runner.py:517-534``), with ``--device``
    (CUDA by default, as every entry point of the port)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scenario", choices=sorted(_SCENARIOS))
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--horizon", type=int, default=None,
                   help="override the MPC horizon N")
    p.add_argument("--telemetry-out", type=str, default=None)
    p.add_argument("--log-every", type=int, default=40)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    cosim = _make(args.scenario, n_override=args.horizon, device=args.device)
    summary = cosim.run(args.steps, log_every=args.log_every)
    if args.telemetry_out:
        cosim.export_telemetry(args.telemetry_out)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
