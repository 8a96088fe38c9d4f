"""Write the JAX reference outputs that ``chip_smoke.py`` holds the port against.

The machine with the GPU has no JAX, so each batch the port drives there is
compared with a stored run of the reference package: the batch
(``build_barc_lmpc(n, K, K_lap)``, ``make_scenario_batch(batch, seed=0)``)
solved by ``jax.jit(jax.vmap(RacingMPC._solve_impl))`` on the CPU, plus, per
lane, the certified float64 optimum of the reference's condensed QP
(``mpc.reference_qp.solve_dense_qp_f64``; NaN where it does not certify).
It also stores the reference solved again ``PERT_SEEDS`` times on the same
batch, each time with the initial state and reference trajectory perturbed
by ~2e-7 relative (about one f32 rounding) from its own seed: the largest
spread between those runs and the first is the reference's own
repeatability, the yardstick for the port's differences from it.

The controller cycle is held the same way: each ``ctrl_*.npz`` of
``CTRL_CASES`` holds closed-loop runs of the reference's ``CoSimulation`` of
a launch scenario, the run itself and re-runs in which every state the
controller receives is moved by ~2e-7 relative from its own seed (see
``reference_ctrl_run``).

The other paths of the port are held the same way: ``ADMM_CASES`` is the
flagship batch solved by the ADMM backend (``qp_method="admm"``; its
certified optima are the IPM case's, the QPs being the same; it also holds
the reference's runs of each lane alone, see ``compute_admm``);
``CTRL_CASES`` also holds BARC LMPC runs with the safe-set error-dynamics
regression switched on (each cycle's dA/dB/dC stored); ``CONT_CASES`` holds
runs of ``ContinuousCoSimulation`` with an EKF filtering noisy
observations between plant and controller and an actuation outage (see
``reference_continuous_run``); ``stack`` holds the LQR and the legacy
controller on the inputs ``chip_smoke.stack_problem`` makes (see
``compute_stack``); ``BUS_CASES`` holds runs of ``BusCoSimulation``, the
two nodes over the native bus (see ``reference_bus_run``); ``ENTRY_CASE``
holds the reference's ``__graft_entry__.entry()`` solve (see
``compute_entry``); ``BENCH_CHAIN_CASES`` and ``BENCH_RT_CASES`` hold
bench.py's dependent chains of solves and of controller cycles, which the
port's bench (``racing_lmpc_torch/bench.py``) is held to (see
``compute_bench_chain`` and ``compute_bench_rt``); ``TOOLS_ENGINE_CASE``,
``TOOLS_SS_CASE`` and ``TOOLS_CAPTURE_CASE`` hold what the port's tools
(``racing_lmpc_torch/tools``) are held to: the reference tool's engine
records, the seed-lap recorder's first cycles, and the spread of
scripts/ground_accuracy.py's captures (see ``compute_tools_engine``,
``compute_tools_putnam_ss`` and ``compute_tools_capture``);
``DT_LMPC_FIXTURES`` hold the double-track LMPC batches at the shipped
learning horizons, n = 275 and 244 (see ``compute_dt_lmpc``).

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py [case ...]

It writes ``tests/data/torch_port/<case>.npz`` for each case named (every
case when none is).
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURE_DIR = ROOT / "tests" / "data" / "torch_port"
# case -> (n_horizon, num_ss, num_ss_per_lap, batch): the flagship batch and
# the shipped barc_lmpc.param.yaml horizon at bench.py's batch for it
CASES = {
    "barc_n20_k48_b256": (20, 48, 16, 256),
    "barc_n40_k96_b128": (40, 96, 32, 128),
}
SEED = 0
PERT_SEEDS = 8
# controller case -> (launch scenario, closed-loop cycles (the first one
# bootstraps), moved re-runs, CoSimulation arguments): the shipped widths
# that chip_smoke.py drives, and a cut of each that the CPU tests replay
SMALL = {"n_override": 10, "mpc_overrides": {"num_ss_pts": 16}}
# the error-dynamics regression of tests/test_lmpc.py:97-100: dist_max, and
# groups (state inputs, control inputs, output state): the v_tran and
# yaw-rate errors from (v_long, v_tran, yaw rate, u)
REGRESSION = (3.0, (((3, 4, 5), (0, 1), 4), ((3, 4, 5), (0, 1), 5)))
CTRL_CASES = {
    "ctrl_barc_lmpc": ("barc_lmpc", 20, 4, {}),
    "ctrl_putnam_short_lmpc": ("putnam_short_lmpc", 8, 4, {}),
    "ctrl_barc_lmpc_n10": ("barc_lmpc", 3, 8, SMALL),
    "ctrl_putnam_short_lmpc_n10": ("putnam_short_lmpc", 3, 8, SMALL),
    "ctrl_barc_lmpc_regression": ("barc_lmpc", 8, 4, {"regression": REGRESSION}),
    "ctrl_barc_lmpc_regression_n10": ("barc_lmpc", 3, 8,
                                      {**SMALL, "regression": REGRESSION}),
}
# the flagship batch through the ADMM backend: case -> (IPM case whose batch
# and certified optima it shares, RacingMPCConfig overrides)
ADMM_CASES = {"barc_n20_k48_b256_admm": ("barc_n20_k48_b256", {"qp_method": "admm"})}
# continuous co-simulation case -> (launch scenario, plant ticks, moved
# re-runs, actuation outage [t0, t1) in s, ContinuousCoSimulation arguments):
# 10 ms plant ticks under the 25 ms controller, the shipped widths for the
# card and a cut for the CPU tests
CONT_CASES = {
    "ctrl_barc_lmpc_continuous_ekf": ("barc_lmpc", 50, 4, (0.2, 0.3), {}),
    "ctrl_barc_lmpc_continuous_ekf_n10": ("barc_lmpc", 8, 4, (0.03, 0.06), SMALL),
}
# the EKF between plant and controller (tests/test_estimator_in_loop.py:26-63):
# full-state observations with this noise, from numpy seed EKF_SEED
EKF_NOISE_STD = (0.01, 0.01, 0.01, 0.03, 0.01, 0.05)
EKF_SEED = 11
# moved copies of the legacy controller's solves (compute_stack)
LEGACY_MOVED = 4
# bus co-simulation case -> (launch scenario, cycles, moved re-runs,
# BusCoSimulation arguments): tests/test_native.py's smoke run
BUS_CASES = {"bus_barc_tracking_mpc_n10": ("barc_tracking_mpc", 5, 4, {"n_override": 10})}
# the flagship solve of __graft_entry__.entry(): one scenario (N=20, K=48)
ENTRY_CASE = "entry_barc_n20_k48"
# the dependent chains of bench.py:152-175 (racing_lmpc_torch/bench.py::
# chain_solves): case -> (n_horizon, num_ss, chain length, batches), each
# batch the leading lanes of bench.py's flagship batch of 256
BENCH_CHAIN_CASES = {"bench_chain_n20_k48": (20, 48, 3, (1, 2))}
# the controller chain of bench.py:57-112 (racing_lmpc_torch/bench.py::
# rt_chain) of each launch scenario: case -> (launch scenario, chain
# length, moved re-runs of the chain and of each cycle)
BENCH_RT_CASES = {f"bench_rt_{name}": (name, 2, 4) for name in (
    "barc_lmpc", "barc_tracking_mpc", "putnam_short_lmpc", "putnam_short_tracking_mpc",
    "putnam_config_a_tracking_mpc")}


def fixture_path(case: str) -> Path:
    return FIXTURE_DIR / f"{case}.npz"


def _jax_on_cpu():
    """JAX on the CPU, with the persistent compilation cache of the test
    suite (tests/conftest.py): each controller run builds its own jitted
    functions, and the cache compiles each program once."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import platform
    import jax
    jax.config.update("jax_platforms", "cpu")
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", str(
            ROOT / ".jax_cache" / f"fixture-{platform.machine()}"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_STATE_FIELDS = (("p", "s"), ("p", "x_tran"), ("p", "e_psi"),
                 ("v", "v_long"), ("v", "v_tran"), ("w", "w_psi"))


def _mover(move_seed: int):
    """A state filter scaling every state a controller receives by
    1 + 2e-7 N(0, 1) from numpy seed ``move_seed``: about one f32 rounding."""
    rng = np.random.default_rng(move_seed)

    def move(msg):
        msg = copy.deepcopy(msg)
        for part, name in _STATE_FIELDS:
            obj = getattr(msg, part)
            setattr(obj, name, getattr(obj, name) * (1 + 2e-7 * rng.standard_normal()))
        return msg
    return move


def reference_ctrl_run(scenario: str, steps: int, move_seed: int | None = None,
                       **cosim_kw) -> dict:
    """``steps`` lock-step cycles of the reference's ``CoSimulation`` of a
    launch scenario (``cosim_kw`` goes to its constructor).  With
    ``move_seed``, every state the controller receives is scaled by
    1 + 2e-7 N(0, 1) (numpy seed ``move_seed``) before it is rounded to f32:
    about one f32 rounding.  Returns, per cycle: the controller's input
    ``x_ctrl`` (f32, as it was handed to ``MPCController.step``) and
    ``u_ic``, its ``u_apply``, ``obj`` and ``used_fallback``, and the plant's
    abscissa ``s``, lateral offset ``x_tran`` and ``lap`` after the cycle."""
    _jax_on_cpu()
    from racing_lmpc_tpu.control.loop import RegressionSpec
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation

    cosim_kw = dict(cosim_kw)
    regression = cosim_kw.pop("regression", None)
    cs = CoSimulation(_SCENARIOS[scenario], **cosim_kw)
    regs = []
    if regression is not None:
        # a use of the reference's own objects: its controller takes the
        # regression as an attribute
        cs.controller.regression = RegressionSpec(*regression)
        query = cs.controller._query_regression

        def recording_query(x_np, u_np):
            r = query(x_np, u_np)
            regs.append(tuple(np.asarray(a, np.float32) for a in r))
            return r
        cs.controller._query_regression = recording_query
    seen = []
    step = cs.controller.step

    def recording_step(x_ic, u_ic=None):
        seen.append((np.asarray(x_ic, np.float32), np.asarray(u_ic, np.float32)))
        return step(x_ic, u_ic)

    cs.controller.step = recording_step
    if move_seed is not None:
        cs.state_filter = _mover(move_seed)
    plant = []
    for _ in range(steps):
        act = cs.controller_cycle(cs.vehicle_state_msg())
        msg = cs.plant_cycle(act)
        plant.append((msg.p.s, msg.p.x_tran, cs.lap_num))
    tel = cs.telemetry
    s, x_tran, lap = (np.asarray(v) for v in zip(*plant))
    extra = {}
    if regression is not None:
        extra = {k: np.stack([r[i] for r in regs]) for i, k in enumerate(("dA", "dB", "dC"))}
    return {**extra, "x_ctrl": np.stack([x for x, _ in seen]),
            "u_ic": np.stack([u for _, u in seen]),
            "u_apply": np.asarray([t.control for t in tel], np.float32),
            "obj": np.asarray([t.cost for t in tel], np.float32),
            "used_fallback": np.asarray([not t.solved for t in tel]),
            "s": s, "x_tran": x_tran, "lap": lap,
            "total_length": np.float64(cs.track.total_length),
            "scale_u": np.asarray(cs.controller.mpc.scale_u)}


def reference_bus_run(scenario: str, steps: int, move_seed: int | None = None,
                      **bus_kw) -> dict:
    """``steps`` cycles of the reference's ``BusCoSimulation`` of a launch
    scenario, the states moved as ``reference_ctrl_run`` moves them when
    ``move_seed`` is given.  Returns what ``reference_ctrl_run`` does, the
    actuation each cycle published (``u_a``, ``u_steer``) and the run's
    summary counts."""
    _jax_on_cpu()
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, BusCoSimulation

    bus = BusCoSimulation(_SCENARIOS[scenario], **bus_kw)
    cs = bus.cs
    seen, acts, plant = [], [], []
    step, ctrl_cycle, plant_cycle = (cs.controller.step, cs.controller_cycle,
                                     cs.plant_cycle)

    def recording_step(x_ic, u_ic=None):
        seen.append((np.asarray(x_ic, np.float32), np.asarray(u_ic, np.float32)))
        return step(x_ic, u_ic)

    def recording_cycle(msg):
        act = ctrl_cycle(msg)
        acts.append((act.u_a, act.u_steer))
        return act

    def recording_plant(act):
        msg = plant_cycle(act)
        plant.append((msg.p.s, msg.p.x_tran, cs.lap_num))
        return msg

    cs.controller.step = recording_step
    cs.controller_cycle = recording_cycle
    cs.plant_cycle = recording_plant
    if move_seed is not None:
        cs.state_filter = _mover(move_seed)
    try:
        summary = bus.run(steps, timeout_s=3600.0)
    finally:
        bus.close()
    tel = cs.telemetry
    s, x_tran, lap = (np.asarray(v) for v in zip(*plant))
    u_a, u_steer = (np.asarray(v) for v in zip(*acts))
    return {"x_ctrl": np.stack([x for x, _ in seen]),
            "u_ic": np.stack([u for _, u in seen]),
            "u_apply": np.asarray([t.control for t in tel], np.float32),
            "obj": np.asarray([t.cost for t in tel], np.float32),
            "used_fallback": np.asarray([not t.solved for t in tel]),
            "s": s, "x_tran": x_tran, "lap": lap, "u_a": u_a, "u_steer": u_steer,
            "bus_messages": np.int64(summary["bus_messages"]),
            "total_length": np.float64(cs.track.total_length),
            "scale_u": np.asarray(cs.controller.mpc.scale_u)}


def compute_bus(case: str) -> dict:
    """A bus co-simulation fixture: the reference run and its moved re-runs
    stacked on a leading run axis."""
    scenario, steps, moved, kw = BUS_CASES[case]
    runs = [reference_bus_run(scenario, steps, move_seed=s or None, **kw)
            for s in range(moved + 1)]
    single = ("total_length", "scale_u")
    out = {k: np.stack([r[k] for r in runs]) for k in runs[0] if k not in single}
    out.update({k: runs[0][k] for k in single})
    return out


def compute_ctrl(case: str) -> dict:
    """A controller fixture: the reference run and its moved re-runs (seeds
    1, 2, ...) stacked on a leading run axis."""
    scenario, steps, moved, kw = CTRL_CASES[case]
    runs = [reference_ctrl_run(scenario, steps, move_seed=s or None, **kw)
            for s in range(moved + 1)]
    out = {k: np.stack([r[k] for r in runs]) for k in runs[0]
           if k not in ("total_length", "scale_u")}
    out.update(total_length=runs[0]["total_length"], scale_u=runs[0]["scale_u"])
    return out


def ekf_config_arrays(nx: int = 6) -> dict:
    """The EKF between plant and controller, as
    tests/test_estimator_in_loop.py:31-37 configures it."""
    return {"x0": np.asarray([1.0, 0.0, 0.0, 1.5, 0.0, 0.0]),
            "p0": (np.eye(nx) * 0.1).ravel(), "q": (np.eye(nx) * 1e-3).ravel(),
            "x_max": np.full(nx, np.inf), "x_min": np.full(nx, -np.inf)}


def reference_continuous_run(scenario: str, ticks: int, outage: tuple,
                             move_seed: int | None = None, **cont_kw) -> dict:
    """``ticks`` plant ticks of the reference's ``ContinuousCoSimulation``
    (10 ms plant, the scenario's 25 ms controller), actuation dropped for
    simulated times in ``outage``, with an EKF full-state filter between
    plant and controller: every controller cycle the published state plus
    seeded noise (``EKF_NOISE_STD``, numpy seed ``EKF_SEED``) is one
    observation at the cycle's simulated time, after the previous applied
    control.  With ``move_seed`` the estimate is then moved by about one f32
    rounding.  Returns per controller cycle what ``reference_ctrl_run``
    returns and the EKF's inputs and outputs (``ekf_z``, ``ekf_t_ns``,
    ``ekf_u``, ``ekf_x``, ``ekf_P``), and per tick the published abscissa,
    lateral offset and lap."""
    _jax_on_cpu()
    from racing_lmpc_tpu.config import EKFConfig
    from racing_lmpc_tpu.estimation import EKFStateEstimator
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, ContinuousCoSimulation

    sim = ContinuousCoSimulation(_SCENARIOS[scenario], **cont_kw)
    cs = sim.cs
    ekf_cfg = ekf_config_arrays()
    ekf = EKFStateEstimator(EKFConfig(**{k: tuple(v) for k, v in ekf_cfg.items()}),
                            cs.ctrl_model)
    ekf.register_observation("full_state", 6, lambda x, z: x)
    ekf.initialize(0)
    rng = np.random.default_rng(EKF_SEED)
    std = np.asarray(EKF_NOISE_STD)
    R = np.diag(std ** 2).astype(np.float32)
    move = _mover(move_seed) if move_seed is not None else None
    log = {k: [] for k in ("ekf_z", "ekf_t_ns", "ekf_u", "ekf_x", "ekf_P")}

    def filt(msg):
        truth = np.array([getattr(getattr(msg, a), b) for a, b in _STATE_FIELDS])
        z = truth + rng.standard_normal(6) * std
        t_ns = int(round(msg.t * 1e9))
        u = np.asarray(cs._u_prev, np.float32)
        ekf.update_control(u)
        res = ekf.update_observation("full_state", t_ns, z, R)
        xh = np.asarray(res["x"], np.float64)
        for v, k in zip((z, t_ns, u, np.asarray(res["x"]), np.asarray(res["P"])), log):
            log[k].append(v)
        for (a, b), v in zip(_STATE_FIELDS, xh):
            setattr(getattr(msg, a), b, v)
        return move(msg) if move is not None else msg
    cs.state_filter = filt

    seen = []
    step = cs.controller.step

    def recording_step(x_ic, u_ic=None):
        seen.append((np.asarray(x_ic, np.float32), np.asarray(u_ic, np.float32)))
        return step(x_ic, u_ic)
    cs.controller.step = recording_step
    t0, t1 = outage
    summary = sim.run(ticks, actuation_gate=lambda t: not (t0 <= t < t1))
    tel = cs.telemetry
    return {"x_ctrl": np.stack([x for x, _ in seen]),
            "u_ic": np.stack([u for _, u in seen]),
            "u_apply": np.asarray([t.control for t in tel], np.float32),
            "obj": np.asarray([t.cost for t in tel], np.float32),
            "used_fallback": np.asarray([not t.solved for t in tel]),
            "s": np.asarray([m.p.s for m in sim.published]),
            "x_tran": np.asarray([m.p.x_tran for m in sim.published]),
            "lap": np.asarray([m.lap_num for m in sim.published]),
            "published_states": np.int64(summary["published_states"]),
            "controller_cycles": np.int64(summary["controller_cycles"]),
            **{k: np.stack(v) for k, v in log.items()},
            "total_length": np.float64(cs.track.total_length),
            "scale_u": np.asarray(cs.controller.mpc.scale_u)}


_SINGLE = ("total_length", "scale_u", "published_states", "controller_cycles")


def compute_cont(case: str) -> dict:
    """A continuous co-simulation fixture: the reference run and its moved
    re-runs (seeds 1, 2, ...) stacked on a leading run axis, with the EKF
    configuration."""
    scenario, ticks, moved, outage, kw = CONT_CASES[case]
    runs = [reference_continuous_run(scenario, ticks, outage, move_seed=s or None, **kw)
            for s in range(moved + 1)]
    out = {k: np.stack([r[k] for r in runs]) for k in runs[0] if k not in _SINGLE}
    out.update({k: runs[0][k] for k in _SINGLE})
    out.update({f"ekf_cfg_{k}": v for k, v in ekf_config_arrays().items()})
    return out


def compute_stack() -> dict:
    """The LQR's ``solve_batch`` on ``STACK_BATCH`` initial states and three
    legacy-controller solves, as the reference computes them, the legacy
    solves also from ``LEGACY_MOVED`` moved copies of their initial
    states."""
    _jax_on_cpu()
    import dataclasses
    import jax.numpy as jnp
    from racing_lmpc_tpu.config import (
        PARAM_DIR, TRACK_DIR, barc_vehicle, load_ros_params, lqr_config_from_params,
        single_track_config_from_params, vehicle_config_from_params)
    from racing_lmpc_tpu.control import RacingLMPCLegacy, RacingLMPCLegacyConfig
    from racing_lmpc_tpu.models import SingleTrackPlanarModel
    from racing_lmpc_tpu.mpc.racing_lqr import RacingLQR
    from racing_lmpc_tpu.ops.integrators import rk4
    from racing_lmpc_tpu.track import RacingTrajectory

    from chip_smoke import STACK_BATCH, stack_problem
    inputs, legacy = stack_problem()
    p = load_ros_params(PARAM_DIR / "sample_vehicle_base.param.yaml",
                        PARAM_DIR / "sample_vehicle_single_track.param.yaml")
    base = vehicle_config_from_params(p)
    base = dataclasses.replace(base, modeling=dataclasses.replace(
        base.modeling, use_frenet=False, integrator_type="rk4", sample_throttle=60.0))
    model = SingleTrackPlanarModel(base, single_track_config_from_params(
        p, simplify_lon_control=False))
    cfg = lqr_config_from_params(load_ros_params(PARAM_DIR / "sample_lqr.param.yaml"))
    x = jnp.asarray([0.0, 0.0, 0.0, 30.0, 0.0, 0.0], jnp.float32)
    u = jnp.asarray([500.0, 0.0, 0.01], jnp.float32)
    X = [x]
    for _ in range(cfg.n - 1):
        x = rk4(model.dynamics, x, u, jnp.zeros(()), jnp.asarray(cfg.dt, jnp.float32))
        X.append(x)
    X_ref = np.asarray(jnp.stack(X))
    U_ref = np.tile(np.asarray(u), (cfg.n - 1, 1))
    x_ics = (X_ref[0] + inputs["lqr_pert"]).astype(np.float32)
    B = STACK_BATCH
    sol = RacingLQR(cfg, model).solve_batch(
        jnp.asarray(x_ics), jnp.asarray(np.tile(X_ref, (B, 1, 1))),
        jnp.asarray(np.tile(U_ref, (B, 1, 1))))

    bm = SingleTrackPlanarModel(*barc_vehicle())
    track = RacingTrajectory.from_file(TRACK_DIR / "barc" / "02_barc_center.txt")
    ctrl = RacingLMPCLegacy(RacingLMPCLegacyConfig(**legacy), bm, track)
    def legacy_runs(x_ics):
        outs = [ctrl.solve(x0, inputs["leg_X_ref"], np.zeros((legacy["n"] - 1, 2), np.float32),
                           float(inputs["leg_dt"])) for x0 in x_ics]
        return (np.stack([np.asarray(o.U_optm) for o in outs]),
                np.stack([np.asarray(o.X_optm) for o in outs]),
                np.asarray([float(o.obj) for o in outs], np.float32),
                np.asarray([bool(o.solved) for o in outs]))

    # the legacy solves again from initial states moved by about one f32
    # rounding (seeds 1, 2, ...): the reference's own repeatability
    leg = legacy_runs(inputs["leg_x_ic"])
    moved = [legacy_runs((inputs["leg_x_ic"] * (1 + 2e-7 * np.random.default_rng(s)
                                                 .standard_normal(inputs["leg_x_ic"].shape))
                          ).astype(np.float32)) for s in range(1, LEGACY_MOVED + 1)]
    out = {**inputs, "lqr_X_ref": X_ref, "lqr_U_ref": U_ref,
           "lqr_u": np.asarray(sol.u), "lqr_U_optm": np.asarray(sol.U_optm),
           "lqr_X_optm": np.asarray(sol.X_optm)}
    for i, k in enumerate(("U_optm", "X_optm", "obj", "solved")):
        out[f"leg_{k}"] = leg[i]
        out[f"leg_{k}_pert"] = np.stack([m[i] for m in moved])
    return out


def compute_admm(case: str) -> dict:
    """The ADMM backend on the IPM case's batch: the reference's outputs on
    the batch, on each moved input (as ``compute`` makes them) and on each
    lane alone, through ``solve`` and as a batch of one (``U_alone``,
    ``obj_alone``, ``solved_alone``); the inputs and certified optima stay
    in the IPM case's file."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.benchmarks import build_barc_lmpc, make_scenario_batch

    ipm_case, overrides = ADMM_CASES[case]
    n_horizon, num_ss, per_lap, batch = CASES[ipm_case]
    _, track, _, mpc, manager = build_barc_lmpc(
        n_horizon=n_horizon, num_ss=num_ss, num_ss_per_lap=per_lap, **overrides)
    inp = make_scenario_batch(mpc, track, manager, batch, seed=SEED)
    with np.load(fixture_path(ipm_case)) as z:
        assert np.array_equal(np.asarray(inp.x_ic), z["inp_x_ic"])
    z0 = jnp.zeros((batch, mpc.layout.n), jnp.float32)
    no_warm = jnp.zeros((batch,), bool)
    runs = [mpc.solve_batch(inp, z0, no_warm)[0]]
    for s in range(PERT_SEEDS):
        rng = np.random.default_rng(SEED + 1 + s)

        def perturb(a):
            a = np.asarray(a)
            return jnp.asarray((a * (1 + 2e-7 * rng.standard_normal(a.shape)))
                               .astype(np.float32))

        runs.append(mpc.solve_batch(
            inp._replace(x_ic=perturb(inp.x_ic), X_ref=perturb(inp.X_ref)),
            z0, no_warm)[0])
    # each lane of the batch alone, through the single-solve entry point and
    # as a batch of one: the same code on the same inputs in other XLA
    # programs, so other orders of its f32 sums.  The moved inputs keep
    # most of the batch's rounding; these runs sample the reference's spread
    # over rounding itself (tests/torch_port_admm_rounding.py)
    def lane(b):
        return jax.tree_util.tree_map(lambda a: a[b:b + 1], inp)
    alone = [[mpc.solve(jax.tree_util.tree_map(lambda a: a[0], lane(b)))[0]
              for b in range(batch)],
             [jax.tree_util.tree_map(lambda a: a[0], mpc.solve_batch(
                 lane(b), z0[:1], no_warm[:1])[0]) for b in range(batch)]]
    out = runs[0]
    return {"U_optm": np.asarray(out.U_optm), "obj": np.asarray(out.obj),
            "solved": np.asarray(out.solved), "r_prim": np.asarray(out.r_prim),
            "r_dual": np.asarray(out.r_dual),
            "U_pert": np.stack([np.asarray(o.U_optm) for o in runs[1:]]),
            "obj_pert": np.stack([np.asarray(o.obj) for o in runs[1:]]),
            "solved_pert": np.stack([np.asarray(o.solved) for o in runs[1:]]),
            "U_alone": np.asarray([[np.asarray(o.U_optm) for o in a] for a in alone]),
            "obj_alone": np.asarray([[float(o.obj) for o in a] for a in alone], np.float32),
            "solved_alone": np.asarray([[bool(o.solved) for o in a] for a in alone]),
            "scale_u": np.asarray(mpc.scale_u)}


# ---------------------------------------------------------------------------
# the nonlinear-row paths (chip_smoke.NL_*, MODEL_CTRL_CASES): the kinematic
# bicycle and the double-track with their linearized constraint rows
# ---------------------------------------------------------------------------

# nl case -> (scenario, the solve: "sqp" or "batch")
NL_CASES = {"nl_qp_n10": (None, "build"),
            "nl_kinematic": ("kinematic", "sqp"),
            "nl_double_track_sqp": ("double_track", "sqp"),
            "nl_double_track_b256": ("double_track", "batch")}
# closed-loop case -> (chip_smoke.MODEL_CTRL_CASES entry, horizon, cycles
# after the first, moved re-runs): the card's depth, and an N=10 cut of a
# few cycles that the CPU tests replay
MODEL_CTRL_FIXTURES = {
    "ctrl_kinematic": ("ctrl_kinematic", None, None, 4),
    "ctrl_double_track": ("ctrl_double_track", None, None, 4),
    "ctrl_kinematic_n10": ("ctrl_kinematic", 10, 3, 8),
    "ctrl_double_track_n10": ("ctrl_double_track", 10, 3, 8),
}


# the double-track LMPC cases the card drives (chip_smoke.DT_LMPC_CASES): the
# shipped learning horizons, n = 275 and 244
DT_LMPC_FIXTURES = ("dt_lmpc_iac_n60_b32", "dt_lmpc_sample_n50_b1")


def nl_problem(kind: str, n: int, free: bool = False):
    """The reference's (model, track, mpc) of a nonlinear-row scenario, as
    tests/test_nl_constraints.py builds them (``chip_smoke.nl_problem`` is
    the port's)."""
    _jax_on_cpu()
    from racing_lmpc_tpu import config as jc
    from racing_lmpc_tpu.models import DoubleTrackPlanarModel, KinematicBicycleModel
    from racing_lmpc_tpu.mpc.racing_mpc import RacingMPC
    from racing_lmpc_tpu.track import RacingTrajectory
    no_box = dict(x_min=(), x_max=(), u_min=(), u_max=())
    if kind == "kinematic":
        p = jc.load_ros_params(jc.PARAM_DIR / "barc_base.param.yaml",
                               jc.PARAM_DIR / "barc_single_track.param.yaml")
        model = KinematicBicycleModel(jc.vehicle_config_from_params(p),
                                      jc.single_track_config_from_params(
                                          p, simplify_lon_control=False, p_max=1.2))
        track_file = jc.TRACK_DIR / "barc" / "02_barc_center.txt"
        eye3 = tuple(np.eye(3).ravel() * 0.01)
        cfg = jc.barc_mpc_config("barc_tracking_mpc", n=n, learning=False,
                                 r=eye3, r_d=eye3, q_vel=8.0, **no_box)
    else:
        p = jc.load_ros_params(jc.PARAM_DIR / "sample_vehicle_base.param.yaml",
                               jc.PARAM_DIR / "sample_vehicle_double_track.param.yaml")
        model = DoubleTrackPlanarModel(jc.vehicle_config_from_params(p),
                                       jc.double_track_config_from_params(p))
        track_file = jc.TRACK_DIR / "putnam" / "10_putnam_optm.txt"
        eye3 = tuple((np.eye(3) * np.array([1e-7, 1e-7, 0.05])).ravel())
        cfg = jc.barc_mpc_config("iac_car_tracking_mpc", n=n, learning=False,
                                 r=eye3, r_d=eye3, q_vel=20.0, q_boundary=1000.0,
                                 q_contour=50.0, q_heading=20.0, **no_box)
    if free:
        model.n_nl = 0
    return model, RacingTrajectory.from_file(track_file), RacingMPC(cfg, model)


def nl_input(mpc, track, x_ic, v0, v_target, dt) -> dict:
    """tests/test_nl_constraints.py's ``_mk_input`` as numpy arrays."""
    import jax.numpy as jnp
    from chip_smoke import nl_reference
    N, nx, nu, K = mpc.N, mpc.nx, mpc.nu, mpc.K
    s_hor, vels = nl_reference(N, x_ic, v0, v_target, dt)
    X_ref = np.zeros((N, nx), dtype=np.float32)
    X_ref[:, 0] = s_hor
    X_ref[:, mpc.idx_vel] = vels
    s_j = jnp.asarray(s_hor, jnp.float32)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"x_ic": f32(x_ic), "u_ic": np.zeros(nu, np.float32), "X_ref": X_ref,
            "U_ref": np.zeros((N - 1, nu), np.float32), "T_ref": np.full(N - 1, dt, np.float32),
            "bound_left": f32(track.left_boundary(s_j)),
            "bound_right": f32(track.right_boundary(s_j)),
            "total_length": np.float32(track.total_length),
            "curvatures": f32(track.curvature(s_j)), "vel_ref": f32(vels),
            "ss_x": np.zeros((K, nx), np.float32), "ss_j": np.zeros(K, np.float32)}


def _moved_fields(fields: dict, s: int) -> dict:
    """x_ic and X_ref scaled by 1 + 2e-7 N(0, 1) from numpy seed 1 + s, as
    ``chip_smoke.moved`` reproduces them."""
    rng = np.random.default_rng(1 + s)
    out = dict(fields)
    for k in ("x_ic", "X_ref"):
        a = fields[k]
        out[k] = (a * (1 + 2e-7 * rng.standard_normal(a.shape))).astype(np.float32)
    return out


def _ellipse_max(model, X, U) -> np.ndarray:
    """The largest friction-ellipse residual over the stages of each plan
    (leading dimensions kept)."""
    import jax
    import jax.numpy as jnp
    f = jax.jit(jax.vmap(model.friction_ellipse))
    X, U = np.asarray(X), np.asarray(U)
    lead = U.shape[:-2]
    Xs = jnp.asarray(X[..., :-1, :].reshape(-1, X.shape[-1]))
    Us = jnp.asarray(U.reshape(-1, U.shape[-1]))
    return np.asarray(f(Xs, Us)).reshape(lead + (-1,)).max(-1)


def compute_nl_qp() -> dict:
    """The reference's condensed QP (``_build_qp``) of three lanes of each
    nonlinear-row model at N=10: the kinematic ramp from three initial
    states and the double-track braking lanes, the third lane of each with a
    seeded nonzero control reference (the other two leave the exclusivity
    rows all zero: deactivated).  ``<model>_inp_<field>`` and
    ``<model>_<P|q|A|l|u>``."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from chip_smoke import NL_DT, NL_KIN, dt_batch_states, dt_corner
    from racing_lmpc_tpu.mpc.racing_mpc import MPCInput
    out = {}
    rng = np.random.default_rng(9)
    for kind in ("kinematic", "double_track"):
        c = NL_KIN if kind == "kinematic" else NL_DT
        _, track, mpc = nl_problem(kind, 10)
        if kind == "kinematic":
            x_ics = np.asarray(c["x_ic"]) + np.array([[0, 0, 0, 0], [1.0, 0.05, 0.02, 0.4],
                                                      [2.0, -0.05, -0.02, -0.4]])
        else:
            x_ics = dt_batch_states(dt_corner(track))[:3]
        lanes = [nl_input(mpc, track, x, x[mpc.idx_vel], c["v_target"], c["dt"])
                 for x in x_ics]
        fields = {k: np.stack([f[k] for f in lanes]) for k in lanes[0]}
        f = 2.0 if kind == "kinematic" else 3000.0
        steer = 0.1 if kind == "kinematic" else 0.03
        n1 = fields["U_ref"].shape[1]
        fields["U_ref"][2] = np.stack([rng.uniform(0, f, n1), rng.uniform(-f, 0, n1),
                                       rng.uniform(-steer, steer, n1)], 1).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            data, _ = jax.jit(jax.vmap(mpc._build_qp))(
                MPCInput(**{k: jnp.asarray(v) for k, v in fields.items()}))
        out.update({f"{kind}_inp_{k}": v for k, v in fields.items()})
        out.update({f"{kind}_{k}": np.asarray(v) for k, v in data._asdict().items()})
    return out


def compute_nl(case: str) -> dict:
    """A nonlinear-row fixture: the inputs (``inp_<field>``), the
    reference's runs on them and on moved copies (``NL_MOVED``, a batch
    ``NL_BATCH_MOVED``: ``U_runs``,
    ``X_runs``, ``obj_runs``, ``solved_runs``; a batch case also
    ``r_prim``/``r_dual`` of its first run), the friction-ellipse residual
    of each run of a double-track case (``ell_runs``), and a SQP case's
    run without the constraint rows (``U_free``, ``X_free``)."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from chip_smoke import (
        NL_BATCH_MOVED, NL_DT, NL_DT_BATCH, NL_KIN, NL_MOVED, dt_batch_states, dt_corner)
    from racing_lmpc_tpu.mpc.racing_mpc import MPCInput

    kind, solve = NL_CASES[case]
    c = NL_KIN if kind == "kinematic" else NL_DT
    n = NL_DT_BATCH["n"] if solve == "batch" else c["n"]
    model, track, mpc = nl_problem(kind, n)
    if kind == "kinematic":
        x_ics = np.asarray([c["x_ic"]])
    else:
        s_corner = dt_corner(track)
        x_ics = (dt_batch_states(s_corner) if solve == "batch" else
                 np.asarray([[s_corner - c["before_corner"], 0, 0, 0, 0, c["v0"]]]))
    fields = [nl_input(mpc, track, x, x[mpc.idx_vel], c["v_target"], c["dt"])
              for x in x_ics]
    fields = {k: np.stack([f[k] for f in fields]) for k in fields[0]}
    if solve == "sqp":
        fields = {k: v[0] for k, v in fields.items()}
    moved = NL_BATCH_MOVED if solve == "batch" else NL_MOVED
    runs_in = [fields] + [_moved_fields(fields, s) for s in range(moved)]

    def as_input(f):
        return MPCInput(**{k: jnp.asarray(v) for k, v in f.items()})
    out = {f"inp_{k}": v for k, v in fields.items()}
    if solve == "batch":
        B = len(x_ics)
        z0 = jnp.zeros((B, mpc.layout.n), jnp.float32)
        no_warm = jnp.zeros((B,), bool)
        runs = [mpc.solve_batch(as_input(f), z0, no_warm)[0] for f in runs_in]
        out.update(r_prim=np.asarray(runs[0].r_prim), r_dual=np.asarray(runs[0].r_dual))
    else:
        runs = [mpc.solve_sqp(as_input(f), iters=c["sqp_iters"])[0] for f in runs_in]
        free_model, _, free_mpc = nl_problem(kind, n, free=True)
        free, _ = free_mpc.solve_sqp(as_input(fields), iters=c.get("free_iters", c["sqp_iters"]))
        out.update(U_free=np.asarray(free.U_optm), X_free=np.asarray(free.X_optm))
        if kind == "double_track":
            out["ell_free"] = _ellipse_max(model, free.X_optm, free.U_optm)
    out.update(U_runs=np.stack([np.asarray(r.U_optm) for r in runs]),
               X_runs=np.stack([np.asarray(r.X_optm) for r in runs]),
               obj_runs=np.stack([np.asarray(r.obj) for r in runs]),
               solved_runs=np.stack([np.asarray(r.solved) for r in runs]),
               scale_u=np.asarray(mpc.scale_u), scale_x=np.asarray(mpc.scale_x))
    if kind == "double_track":
        out["ell_runs"] = np.stack([_ellipse_max(model, r.X_optm, r.U_optm) for r in runs])
        out["s_corner"] = np.float64(s_corner)
    return out


def dt_lmpc_problem(case: str):
    """The reference's (model, track, mpc, numpy lanes) of a double-track
    LMPC case, as ``chip_smoke.dt_lmpc_problem`` builds the port's."""
    _jax_on_cpu()
    from chip_smoke import DT_LMPC_CASES, DT_LMPC_LAPS, DT_LMPC_TRACK, dt_lmpc_fields, \
        dt_lmpc_overrides
    from racing_lmpc_tpu import config as jc
    from racing_lmpc_tpu.models import DoubleTrackPlanarModel
    from racing_lmpc_tpu.mpc.racing_mpc import RacingMPC
    from racing_lmpc_tpu.safeset import SafeSetManager, SafeSetRecorder
    from racing_lmpc_tpu.track import RacingTrajectory
    p = jc.load_ros_params(jc.PARAM_DIR / "sample_vehicle_base.param.yaml",
                           jc.PARAM_DIR / "sample_vehicle_double_track.param.yaml")
    model = DoubleTrackPlanarModel(jc.vehicle_config_from_params(p),
                                   jc.double_track_config_from_params(p))
    track = RacingTrajectory.from_file(jc.TRACK_DIR.joinpath(*DT_LMPC_TRACK))
    name = DT_LMPC_CASES[case][0]
    cfg = jc.barc_mpc_config(name, **dt_lmpc_overrides(jc.barc_mpc_config(name), case))
    mpc = RacingMPC(cfg, model)
    lap_dir, laps = DT_LMPC_LAPS
    manager = SafeSetManager(laps, nx=6, nu=2)
    SafeSetRecorder(manager).load([str(jc.SS_DIR / lap_dir / f"ss_lap_{i}")
                                   for i in range(1, laps + 1)], track.total_length)
    return model, track, mpc, dt_lmpc_fields(track, manager, case, cfg.num_ss_pts_per_lap)


def dt_lmpc_solver(mpc, entry: str):
    """The reference's solve of a double-track LMPC batch of numpy lanes
    through ``entry``: ``solve_batch`` with no warm start, or ``jax.jit`` of
    ``_solve_impl`` on each lane alone (as ``__graft_entry__.entry`` calls
    it).  Returns the outputs with a leading batch dimension."""
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.mpc.racing_mpc import MPCInput
    n = mpc.layout.n
    one = jax.jit(mpc._solve_impl)

    def solve(fields):
        B = len(fields["x_ic"])
        if entry == "solve_batch":
            inp = MPCInput(**{k: jnp.asarray(v) for k, v in fields.items()})
            return mpc.solve_batch(inp, jnp.zeros((B, n), jnp.float32),
                                   jnp.zeros((B,), bool))[0]
        outs = [one(MPCInput(**{k: jnp.asarray(v[b]) for k, v in fields.items()}),
                    jnp.zeros((n,), jnp.float32), jnp.ones((), bool))[0] for b in range(B)]
        return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)
    return solve


def compute_dt_lmpc(case: str) -> dict:
    """A double-track LMPC fixture (``chip_smoke.DT_LMPC_CASES``): the lanes
    (``inp_<field>``), the reference's runs on them and on
    ``DT_LMPC_MOVED`` moved copies (``U_runs``, ``X_runs``, ``obj_runs``,
    ``solved_runs``, ``ell_runs``; ``r_prim``/``r_dual`` of the first run)
    and the QP's size (``n``, ``m``).  Case A (n = 275, 32 lanes) takes
    ~20 min on the CPU, most of it XLA compiling, case B (n = 244) ~10:

        JAX_PLATFORMS=cpu python tests/torch_port_fixture.py \
            dt_lmpc_iac_n60_b32 dt_lmpc_sample_n50_b1
    """
    _jax_on_cpu()
    from chip_smoke import DT_LMPC_CASES, DT_LMPC_MOVED
    model, _, mpc, fields = dt_lmpc_problem(case)
    solve = dt_lmpc_solver(mpc, DT_LMPC_CASES[case][-1])
    runs = []
    for f in [fields] + [_moved_fields(fields, s) for s in range(DT_LMPC_MOVED)]:
        runs.append(solve(f))
        print(f"{case}: run {len(runs)} solved {int(np.asarray(runs[-1].solved).sum())} "
              f"of {len(fields['x_ic'])}", flush=True)
    out = {f"inp_{k}": v for k, v in fields.items()}
    out.update(U_runs=np.stack([np.asarray(r.U_optm) for r in runs]),
               X_runs=np.stack([np.asarray(r.X_optm) for r in runs]),
               obj_runs=np.stack([np.asarray(r.obj) for r in runs]),
               solved_runs=np.stack([np.asarray(r.solved) for r in runs]),
               ell_runs=np.stack([_ellipse_max(model, r.X_optm, r.U_optm) for r in runs]),
               r_prim=np.asarray(runs[0].r_prim), r_dual=np.asarray(runs[0].r_dual),
               scale_u=np.asarray(mpc.scale_u), n=np.int64(mpc.layout.n),
               m=np.int64(mpc.layout.m))
    return out


def reference_model_ctrl_run(case: str, n: int, cycles: int,
                             move_seed: int | None = None) -> dict:
    """The reference's closed loop of tests/test_closed_loop.py:145-219
    (``chip_smoke.MODEL_CTRL_CASES[case]``) at horizon ``n`` for ``cycles``
    plant steps after the first controller step.  With ``move_seed``,
    every state handed to the controller is scaled by 1 + 2e-7 N(0, 1)
    (numpy seed ``move_seed``), about one f32 rounding.  Returns per
    controller step what ``reference_ctrl_run`` returns (``x_ctrl``,
    ``u_ic``, ``u_apply``, ``obj``, ``used_fallback``) and the plant's state
    after each step (``x_plant``)."""
    _jax_on_cpu()
    from chip_smoke import MODEL_CTRL_CASES
    from racing_lmpc_tpu import config as jc
    from racing_lmpc_tpu.control.loop import MPCController
    from racing_lmpc_tpu.models.factory import load_vehicle_model
    from racing_lmpc_tpu.sim import RacingSimulator
    from racing_lmpc_tpu.track import RacingTrajectory

    kind, _, dt, _, x0 = MODEL_CTRL_CASES[case]
    name, yaml = {"kinematic": ("kinematic_bicycle_model", "barc_single_track"),
                  "double_track": ("double_track_planar_model", "barc_double_track")}[kind]
    model = load_vehicle_model(name, jc.load_ros_params(
        jc.PARAM_DIR / "barc_base.param.yaml", jc.PARAM_DIR / f"{yaml}.param.yaml"))
    track = RacingTrajectory.from_file(jc.TRACK_DIR / "barc" / "02_barc_center.txt")
    r3 = (1e-3, 0, 0, 0, 1e-3, 0, 0, 0, 1.0)
    rd3 = (1e-2, 0, 0, 0, 1e-2, 0, 0, 0, 1.0)
    cfg = jc.barc_mpc_config("barc_tracking_mpc", n=n, learning=False, step_mode="step",
                             r=r3, r_d=rd3, x_max=(), x_min=(), u_max=(), u_min=())
    ctrl = MPCController(cfg, model, track, dt)
    sim = RacingSimulator(jc.SimulatorConfig(dt=dt, x0=x0), model, track)
    rng = np.random.default_rng(move_seed) if move_seed is not None else None
    rows, plant = [], []

    def step(u_ic):
        x = np.asarray(sim.x, np.float32)
        if rng is not None:
            x = (x * (1 + 2e-7 * rng.standard_normal(x.shape))).astype(np.float32)
        info = ctrl.step(x, u_ic=u_ic)
        u = np.zeros(model.nu, np.float32) if u_ic is None else np.asarray(u_ic, np.float32)
        rows.append((x, u, np.asarray(info.u_apply, np.float32), float(info.output.obj),
                     bool(info.used_fallback)))
        return info
    info = step(None)
    for _ in range(cycles):
        sim.step(info.u_base)
        plant.append(np.asarray(sim.x, np.float64))
        info = step(info.u_apply)
    x, u, ua, obj, fb = zip(*rows)
    return {"x_ctrl": np.stack(x), "u_ic": np.stack(u), "u_apply": np.stack(ua),
            "obj": np.asarray(obj, np.float32), "used_fallback": np.asarray(fb),
            "x_plant": np.stack(plant), "scale_u": np.asarray(ctrl.mpc.scale_u)}


def compute_model_ctrl(case: str) -> dict:
    """A closed-loop fixture of the nonlinear-row models: the reference run
    and its moved re-runs (seeds 1, 2, ...) stacked on a leading run axis."""
    _jax_on_cpu()
    from chip_smoke import MODEL_CTRL_CASES
    base, n, cycles, moved = MODEL_CTRL_FIXTURES[case]
    _, n0, _, cycles0, _ = MODEL_CTRL_CASES[base]
    n, cycles = n or n0, cycles or cycles0
    runs = [reference_model_ctrl_run(base, n, cycles, move_seed=s or None)
            for s in range(moved + 1)]
    out = {k: np.stack([r[k] for r in runs]) for k in runs[0] if k != "scale_u"}
    out.update(scale_u=runs[0]["scale_u"], n=np.int64(n))
    return out


def compute(case: str) -> dict:
    """The fixture's arrays: ``inp_<field>`` (the MPCInput), the reference's
    ``U_optm``, ``obj``, ``solved``, ``r_prim``, ``r_dual``, the same
    outputs of each perturbed run stacked on a leading axis (``U_pert``,
    ``obj_pert``, ``solved_pert``), and the certified ``U_star`` /
    ``obj_star`` of each lane's condensed QP."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.benchmarks import build_barc_lmpc, make_scenario_batch

    n_horizon, num_ss, per_lap, batch = CASES[case]
    _, track, _, mpc, manager = build_barc_lmpc(
        n_horizon=n_horizon, num_ss=num_ss, num_ss_per_lap=per_lap)
    inp = make_scenario_batch(mpc, track, manager, batch, seed=SEED)
    z0 = jnp.zeros((batch, mpc.layout.n), jnp.float32)
    no_warm = jnp.zeros((batch,), bool)
    out, _ = mpc.solve_batch(inp, z0, no_warm)

    pert = []
    for s in range(PERT_SEEDS):
        rng = np.random.default_rng(SEED + 1 + s)

        def perturb(a):
            a = np.asarray(a)
            return jnp.asarray((a * (1 + 2e-7 * rng.standard_normal(a.shape)))
                               .astype(np.float32))

        pert.append(mpc.solve_batch(
            inp._replace(x_ic=perturb(inp.x_ic), X_ref=perturb(inp.X_ref)),
            z0, no_warm)[0])
    U_star, obj_star = certified_optima(mpc, inp)
    arrays = {f"inp_{k}": np.asarray(v) for k, v in inp._asdict().items()
              if v is not None}
    arrays.update(
        U_optm=np.asarray(out.U_optm), obj=np.asarray(out.obj),
        solved=np.asarray(out.solved), r_prim=np.asarray(out.r_prim),
        r_dual=np.asarray(out.r_dual),
        U_pert=np.stack([np.asarray(o.U_optm) for o in pert]),
        obj_pert=np.stack([np.asarray(o.obj) for o in pert]),
        solved_pert=np.stack([np.asarray(o.solved) for o in pert]),
        U_star=U_star, obj_star=obj_star, scale_u=np.asarray(mpc.scale_u))
    return arrays


def certified_optima(mpc, inp) -> tuple[np.ndarray, np.ndarray]:
    """(U_star, obj_star): the controls and objective of the certified
    float64 optimum (``mpc.reference_qp.solve_dense_qp_f64``) of each lane's
    condensed QP of the reference's ``mpc`` on the batch ``inp``; NaN where
    it does not certify."""
    import jax
    from racing_lmpc_tpu.mpc.reference_qp import ReferenceQP, solve_dense_qp_f64
    with jax.default_matmul_precision("highest"):
        data, aux = jax.jit(jax.vmap(mpc._build_qp))(inp)
    P, q, A, l, u = (np.asarray(a, np.float64) for a in data)
    MU, mu0 = np.asarray(aux[2], np.float64), np.asarray(aux[3], np.float64)
    su = np.asarray(mpc.scale_u)
    batch = P.shape[0]
    U_star = np.full((batch, mpc.N - 1, mpc.nu), np.nan)
    obj_star = np.full((batch,), np.nan)
    for b in range(batch):
        Pb = 0.5 * (P[b] + P[b].T)
        try:
            z, _ = solve_dense_qp_f64(ReferenceQP(
                P=Pb, q=q[b], A=A[b], l=l[b], u=u[b], layout=None,
                scale_x=None, scale_u=None))
        except RuntimeError:        # not certified: leave the lane NaN
            continue
        U_star[b] = (MU[b] @ z[:mpc.layout.nuu] + mu0[b]).reshape(mpc.N - 1, mpc.nu) * su
        obj_star[b] = 0.5 * z @ (Pb @ z) + q[b] @ z
    return U_star, obj_star


def compute_entry() -> dict:
    """The reference's ``__graft_entry__.entry()``: its ``fn`` jitted on its
    example arguments, and the ``RacingMPC._solve_impl`` call that ``fn``
    makes, jitted on those arguments and on ``PERT_SEEDS`` copies of them
    with x_ic and X_ref moved as ``compute`` moves a batch; with the
    certified optimum of its condensed QP.  Stored as a batched fixture of
    one lane (the scenario is lane 0 of ``make_scenario_batch(batch=1)``):
    what ``compute`` stores, plus ``U_entry``, ``fn``'s own output."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    import __graft_entry__
    from racing_lmpc_tpu.benchmarks import build_barc_lmpc, make_scenario_batch

    fn, (single, z, valid) = __graft_entry__.entry()
    U_entry = np.asarray(jax.jit(fn)(single, z, valid))
    # the same build as the entry's, for the rest of _solve_impl's output
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon=20, num_ss=48)
    inp = make_scenario_batch(mpc, track, manager, batch=1, seed=SEED)
    for a, b in zip(inp, single):
        assert a is None or np.array_equal(np.asarray(a)[0], np.asarray(b))
    solve = jax.jit(lambda i: mpc._solve_impl(i, z, valid)[0])

    def lane(inp_b):
        return solve(jax.tree.map(lambda a: jnp.asarray(a)[0], inp_b))

    out = lane(inp)
    assert np.array_equal(np.asarray(out.U_optm), U_entry)
    fields = {k: np.asarray(v) for k, v in inp._asdict().items() if v is not None}
    pert = [lane(inp._replace(**{k: jnp.asarray(v) for k, v in
                                 _moved_fields(fields, s).items()}))
            for s in range(PERT_SEEDS)]
    U_star, obj_star = certified_optima(mpc, inp)
    one = lambda a: np.asarray(a)[None]  # noqa: E731
    arrays = {f"inp_{k}": v for k, v in fields.items()}
    arrays.update(
        U_entry=U_entry[None], U_optm=one(out.U_optm), obj=one(out.obj),
        solved=one(out.solved), r_prim=one(out.r_prim), r_dual=one(out.r_dual),
        U_pert=np.stack([one(o.U_optm) for o in pert]),
        obj_pert=np.stack([one(o.obj) for o in pert]),
        solved_pert=np.stack([one(o.solved) for o in pert]),
        U_star=U_star, obj_star=obj_star, scale_u=np.asarray(mpc.scale_u))
    return arrays


def compute_bench_chain(case: str) -> dict:
    """bench.py's dependent chains (``:152-175``) on the leading lanes of
    its flagship batch: ``chain`` solves jitted as one scan, step k+1 from
    step k's ``X_optm[:, 1]``, the warm start carried, ``valid`` fixed.
    Stores the inputs of the widest batch (``inp_<field>``) and, per batch
    b, each step's ``obj_b<b>`` (chain, b), ``U_b<b>`` and ``solved_b<b>``,
    with the same of ``PERT_SEEDS`` re-runs on x_ic and X_ref moved as
    ``compute_entry`` moves them (``*_pert``)."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.benchmarks import build_barc_lmpc, make_scenario_batch

    n_horizon, num_ss, chain, batches = BENCH_CHAIN_CASES[case]
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon=n_horizon, num_ss=num_ss)
    inp = make_scenario_batch(mpc, track, manager, 256, seed=SEED)

    def chain_solves(inp_b, z_b, valid_b):
        def body(carry, _):
            inp_c, z_c = carry
            out_c, z_n = jax.vmap(mpc._solve_impl)(inp_c, z_c, valid_b)
            return ((inp_c._replace(x_ic=out_c.X_optm[:, 1]), z_n),
                    (out_c.obj, out_c.U_optm, out_c.solved))
        return jax.lax.scan(body, (inp_b, z_b), None, length=chain)[1]

    f = jax.jit(chain_solves)
    fields = {k: np.asarray(v)[:max(batches)] for k, v in inp._asdict().items()
              if v is not None}
    arrays = {f"inp_{k}": v for k, v in fields.items()}
    for b in batches:
        def run(fl, b=b):
            inp_b = type(inp)(**{k: jnp.asarray(v[:b]) for k, v in fl.items()})
            return [np.asarray(a) for a in f(inp_b, jnp.zeros((b, mpc.layout.n), jnp.float32),
                                             jnp.zeros((b,), bool))]
        obj, U, solved = run(fields)
        pert = [run(_moved_fields(fields, s)) for s in range(PERT_SEEDS)]
        arrays.update({f"obj_b{b}": obj, f"U_b{b}": U, f"solved_b{b}": solved,
                       f"obj_b{b}_pert": np.stack([p[0] for p in pert]),
                       f"U_b{b}_pert": np.stack([p[1] for p in pert])})
    arrays["scale_u"] = np.asarray(mpc.scale_u)
    return arrays


def compute_bench_rt(case: str) -> dict:
    """bench.py's controller chain of a launch scenario (``:57-112``): the
    reference's ``CoSimulation`` after one ``step()`` (bootstrap and first
    cycle), the safe set queried once, then ``chain`` cycles of
    ``MPCController._rti_step`` jitted as one scan, each from the previous
    cycle's ``last_X[1]`` and ``u_apply``.  Stores the start (``state_*``,
    ``x0``, ``u0``, ``ss_x``, ``ss_j``, ``speed_limit``, ``speed_scale``),
    each cycle's ``obj``, ``U_optm``, ``u_apply`` and ``used_fallback``, and
    the same of re-runs from ``last_X`` and ``x0`` moved by one f32
    rounding (numpy seeds 1, 2, ...; ``*_pert``).

    Each cycle is also stored teacher-forced (``tf_*``): the chain run one
    jitted ``_rti_step`` at a time, with each cycle's start (``tf_state_*``,
    ``tf_x0``, ``tf_u0``, by cycle) and its outputs, and each cycle run
    again from its own start moved the same way (``tf_*_pert``, by moved
    run and cycle): the yardstick of a port cycle started where the
    reference's started."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation

    scenario, chain, moved = BENCH_RT_CASES[case]
    cs = CoSimulation(_SCENARIOS[scenario])
    cs.step()
    ctrl = cs.controller
    st = ctrl.state
    ss_x, ss_j = ctrl._query_safe_set(st.last_X[-1])
    lim = jnp.asarray(ctrl.speed_limit, jnp.float32)
    sc = jnp.asarray(ctrl.speed_scale, jnp.float32)

    def chain_steps(state, x0, u0):
        def body(carry, _):
            s, x, u = carry
            s2, info = ctrl._rti_step(x, u, s, ss_x, ss_j, lim, sc)
            return ((s2, s2.last_X[1], info.u_apply),
                    (info.output.obj, info.output.U_optm, info.u_apply, info.used_fallback))
        return jax.lax.scan(body, (state, x0, u0), None, length=chain)[1]

    f = jax.jit(chain_steps)
    x0 = st.last_X[0]
    u0 = jnp.zeros((ctrl.mpc.nu,), jnp.float32)
    keys = ("obj", "U_optm", "u_apply", "used_fallback")
    runs = [f(st, x0, u0)]
    for s in range(moved):
        rng = np.random.default_rng(1 + s)

        def move(a):
            a = np.asarray(a)
            return jnp.asarray((a * (1 + 2e-7 * rng.standard_normal(a.shape))).astype(np.float32))
        runs.append(f(st._replace(last_X=move(st.last_X)), move(x0), u0))
    arrays = {f"state_{k}": np.asarray(v) for k, v in st._asdict().items()}

    def one_step(state, x, u):
        s2, info = ctrl._rti_step(x, u, state, ss_x, ss_j, lim, sc)
        return s2, (info.output.obj, info.output.U_optm, info.u_apply, info.used_fallback)
    one = jax.jit(one_step)
    starts, tf = [], []
    s_c, x_c, u_c = st, x0, u0
    for _ in range(chain):
        starts.append((s_c, x_c, u_c))
        s_c, out = one(s_c, x_c, u_c)
        tf.append(out)
        x_c, u_c = s_c.last_X[1], out[2]
    tf_pert = []
    for s in range(moved):
        rng = np.random.default_rng(1 + s)

        def move(a):
            a = np.asarray(a)
            return jnp.asarray((a * (1 + 2e-7 * rng.standard_normal(a.shape))).astype(np.float32))
        tf_pert.append([one(s_c._replace(last_X=move(s_c.last_X)), move(x_c), u_c)[1]
                        for s_c, x_c, u_c in starts])
    for k in st._fields:
        arrays[f"tf_state_{k}"] = np.stack([np.asarray(getattr(c[0], k)) for c in starts])
    arrays["tf_x0"] = np.stack([np.asarray(c[1]) for c in starts])
    arrays["tf_u0"] = np.stack([np.asarray(c[2]) for c in starts])
    for i, k in enumerate(keys):
        arrays[f"tf_{k}"] = np.stack([np.asarray(o[i]) for o in tf])
        arrays[f"tf_{k}_pert"] = np.stack([[np.asarray(o[i]) for o in r] for r in tf_pert])
    arrays.update(x0=np.asarray(x0), u0=np.asarray(u0), ss_x=np.asarray(ss_x),
                  ss_j=np.asarray(ss_j), speed_limit=np.asarray(lim),
                  speed_scale=np.asarray(sc), scale_u=np.asarray(ctrl.mpc.scale_u))
    for i, k in enumerate(keys):
        arrays[k] = np.asarray(runs[0][i])
        arrays[f"{k}_pert"] = np.stack([np.asarray(r[i]) for r in runs[1:]])
    return arrays


# the tools' fixtures: the reference's engine records (one instance of each
# acceptance scenario at the shipped config and at 2 zoom rounds, each as
# the instance and the copies moved by one f32 rounding that
# racing_lmpc_torch/tools/accuracy.py::acc_copies makes), and the first
# cycles of the Putnam seed-lap recorder's loop
TOOLS_ENGINE_CASE = "tools_engine_runs"
TOOLS_ENGINE_TAGS = ("barc_tracking_mpc[6]", "barc_lmpc[6]", "putnam_short_tracking_mpc[8]")
TOOLS_ENGINE_GRID = ({}, {"qp_zoom_rounds": 2})
TOOLS_ENGINE_FIELDS = ("applied_steer_err", "steer_tail_err", "lon_err", "solved",
                       "objective_gap")
TOOLS_SS_CASE = "tools_putnam_ss"
TOOLS_SS_STEPS = 10
# the moved re-runs of the tools' closed-loop fixtures
TOOLS_MOVED_RUNS = 4


def compute_tools_engine() -> dict:
    """The reference tool's engine record (scripts/ground_accuracy.py:
    227-271: ``RacingMPC._solve_jit`` of the instance from its stored warm
    start, through ``CoSimulation(_SCENARIOS[scenario], n_override,
    mpc_overrides)``) of each of ``TOOLS_ENGINE_TAGS`` at each override set
    of ``TOOLS_ENGINE_GRID``, for the exact instance and its moved copies
    (``acc_copies``), with the objective gap of each in the reference QP
    (tests/test_reference_match.py::_sparse_vector).  Stored as
    ``<field>`` arrays (tags, grid points, copies)."""
    _jax_on_cpu()
    import json
    import jax.numpy as jnp
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_tpu.mpc.racing_mpc import MPCInput
    from racing_lmpc_tpu.mpc.reference_qp import build_reference_qp
    from racing_lmpc_torch.tools.accuracy import (
        ACC_REPLICAS, acc_copies, controls, load_instances)
    sys.path.insert(0, str(ROOT / "tests"))
    from test_reference_match import _sparse_vector

    insts = {rec["tag"]: (rec, d) for rec, d in load_instances()[1]}
    out = {f: np.zeros((len(TOOLS_ENGINE_TAGS), len(TOOLS_ENGINE_GRID), ACC_REPLICAS))
           for f in TOOLS_ENGINE_FIELDS}
    for j, overrides in enumerate(TOOLS_ENGINE_GRID):
        for i, tag in enumerate(TOOLS_ENGINE_TAGS):
            rec, d = insts[tag]
            mpc = CoSimulation(_SCENARIOS[rec["scenario"]], n_override=rec["n_override"],
                               mpc_overrides=dict(overrides)).controller.mpc
            copies = acc_copies(d)
            su = d["scale_u"]
            for r in range(ACC_REPLICAS):
                fields = {k: jnp.asarray(v[r]) for k, v in copies.items()}
                inp = MPCInput(**fields, dA=None, dB=None, dC=None)
                o, _ = mpc._solve_jit(inp, jnp.asarray(d["zw"]), jnp.asarray(True))
                rel = np.abs(np.asarray(o.U_optm, np.float64) - controls(d)) / su
                np_inp = MPCInput(**{k: np.asarray(v) for k, v in fields.items()})
                qp = build_reference_qp(mpc.model, mpc.config, np_inp)
                z = _sparse_vector(qp, o, np_inp)
                gap = (qp.objective(z) - qp.objective(d["z_star"])) / max(
                    abs(qp.objective(d["z_star"])), 1.0)
                for f, v in zip(TOOLS_ENGINE_FIELDS, (
                        rel[:2, 1].max(), rel[:, 1].max(), rel[:, 0].max(),
                        bool(o.solved), gap)):
                    out[f][i, j, r] = v
            print(f"{json.dumps(overrides)} {tag}: applied "
                  f"{out['applied_steer_err'][i, j].tolist()}", flush=True)
    return {**out, "tags": np.asarray(TOOLS_ENGINE_TAGS),
            "grid": np.asarray([json.dumps(g, sort_keys=True) for g in TOOLS_ENGINE_GRID])}


def compute_tools_putnam_ss() -> dict:
    """The first ``TOOLS_SS_STEPS`` cycles of scripts/record_putnam_ss.py's
    loop (its spec at the default scale 0.55), the run itself and re-runs in
    which every state the controller receives is moved by one f32 rounding
    (``_mover`` seeds 1 to ``TOOLS_MOVED_RUNS``): each cycle's recorder row
    (state, previous control, curvature, time; from the unmoved state) and
    the cycle's solved flag, stacked (runs, cycles, ...)."""
    _jax_on_cpu()
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation, ScenarioSpec

    trk, lmpc = _SCENARIOS["putnam_short_tracking_mpc"], _SCENARIOS["putnam_short_lmpc"]
    runs = []
    for seed in (None, *range(1, TOOLS_MOVED_RUNS + 1)):
        cs = CoSimulation(ScenarioSpec(**{
            **trk.__dict__, "name": "putnam_short_ss_recording",
            "x0_global": lmpc.x0_global, "dt": lmpc.dt, "velocity_profile_scale": 0.55}))
        if seed is not None:
            cs.state_filter = _mover(seed)
        rows = {"x": [], "u": [], "k": [], "t": []}
        for _ in range(TOOLS_SS_STEPS):
            msg = cs.vehicle_state_msg()
            x = np.array([msg.p.s, msg.p.x_tran, msg.p.e_psi,
                          msg.v.v_long, msg.v.v_tran, msg.w.w_psi])
            u_prev = np.asarray(cs._u_prev, dtype=np.float64)
            for key, v in zip(rows, (x, u_prev, float(cs.track.curvature_np(x[0])), cs._t)):
                rows[key].append(v)
            cs.plant_cycle(cs.controller_cycle(msg))
        runs.append({**rows, "solved": [t.solved for t in cs.telemetry]})
        print(f"putnam recorder run {seed}: solved {runs[-1]['solved']}", flush=True)
    return {k: np.asarray([r[k] for r in runs]) for k in runs[0]}


TOOLS_CAPTURE_CASE = "tools_capture_spread"
# scripts/ground_accuracy.py's first capture point of each scenario
TOOLS_CAPTURE_POINTS = (("barc_tracking_mpc", 20, 6, True), ("barc_lmpc", 20, 6, False),
                        ("putnam_short_tracking_mpc", 30, 8, False))


def compute_tools_capture() -> dict:
    """The reference's own spread at scripts/ground_accuracy.py's first
    capture point of each scenario (``TOOLS_CAPTURE_POINTS``; the tracking
    point with its deviated copy): the capture made in the run itself and in
    re-runs in which every state the controller receives is moved by one f32
    rounding (``_mover`` seeds 1 to ``TOOLS_MOVED_RUNS``), as
    scripts/ground_accuracy.py:95-119 captures it.  Stored per tag: the
    largest difference between two of the runs of P, q, A, l and u
    (relative to the larger's max(1, max |entry|), finite entries) and of
    the certified optimum's controls (over ``scale_u``), and the run itself's
    difference from the pinned instance."""
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_tpu.mpc.reference_qp import build_reference_qp, solve_dense_qp_f64
    from racing_lmpc_torch.tools.accuracy import controls, load_instances

    def rel(a, b):
        fin = np.isfinite(b)
        return float(np.abs(a[fin] - b[fin]).max() / max(1.0, np.abs(b[fin]).max()))

    pinned = {rec["tag"]: d for rec, d in load_instances()[1]}
    tags, spread, drift = [], [], []
    for name, n, at, deviate in TOOLS_CAPTURE_POINTS:
        caps = {}
        for seed in (None, *range(1, TOOLS_MOVED_RUNS + 1)):
            cs = CoSimulation(_SCENARIOS[name], n_override=n)
            if seed is not None:
                cs.state_filter = _mover(seed)
            ctrl, mpc = cs.controller, cs.controller.mpc
            for _ in range(at):
                cs.step()
            msg = cs.vehicle_state_msg()
            x = jnp.asarray([msg.p.s, msg.p.x_tran, msg.p.e_psi,
                             msg.v.v_long, msg.v.v_tran, msg.w.w_psi], dtype=jnp.float32)
            ss_x, ss_j = ctrl._query_safe_set(ctrl.state.last_X[-1])
            inp, _, _ = ctrl.build_step_input(
                x, cs._u_prev, ctrl.state, ss_x, ss_j,
                jnp.asarray(ctrl.speed_limit, jnp.float32),
                jnp.asarray(ctrl.speed_scale, jnp.float32))
            inp = jax.tree.map(np.asarray, inp)
            variants = [(f"{name}[{at}]", inp)]
            if deviate:
                x2 = np.array(inp.x_ic)
                x2[1] += 0.18
                variants.append((f"{name}_dev[{at}]", inp._replace(x_ic=x2)))
            for tag, v in variants:
                qp = build_reference_qp(mpc.model, mpc.config, v)
                z, _ = solve_dense_qp_f64(qp)
                d = {k: getattr(qp, k) for k in "PqAlu"}
                d.update(z_star=z, scale_u=np.asarray(mpc.scale_u), inp_X_ref=v.X_ref)
                caps.setdefault(tag, []).append(d)
            print(f"capture {name} run {seed}", flush=True)
        for tag, runs in caps.items():
            su = runs[0]["scale_u"]

            def reading(a, b):
                return [rel(a[k], b[k]) for k in "PqAlu"] + [float(
                    (np.abs(controls(a) - controls(b)) / su).max())]
            tags.append(tag)
            spread.append(np.max([reading(a, b) for i, a in enumerate(runs)
                                  for j, b in enumerate(runs) if i != j], axis=0))
            drift.append(reading(runs[0], pinned[tag]))
    return {"tags": np.asarray(tags), "spread": np.asarray(spread),
            "drift_from_pinned": np.asarray(drift), "parts": np.asarray([*"PqAlu", "U"])}


def main() -> None:
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for case in sys.argv[1:] or [*CASES, *CTRL_CASES, *ADMM_CASES, *CONT_CASES, "stack",
                                 *NL_CASES, *MODEL_CTRL_FIXTURES, *BUS_CASES, ENTRY_CASE,
                                 *BENCH_CHAIN_CASES, *BENCH_RT_CASES, TOOLS_ENGINE_CASE,
                                 TOOLS_SS_CASE, TOOLS_CAPTURE_CASE, *DT_LMPC_FIXTURES]:
        path = fixture_path(case)
        if case == TOOLS_ENGINE_CASE:
            arrays = compute_tools_engine()
        elif case == TOOLS_SS_CASE:
            arrays = compute_tools_putnam_ss()
        elif case == TOOLS_CAPTURE_CASE:
            arrays = compute_tools_capture()
        elif case in BENCH_CHAIN_CASES:
            arrays = compute_bench_chain(case)
        elif case in BENCH_RT_CASES:
            arrays = compute_bench_rt(case)
        elif case == ENTRY_CASE:
            arrays = compute_entry()
        elif case in BUS_CASES:
            arrays = compute_bus(case)
        elif case in DT_LMPC_FIXTURES:
            arrays = compute_dt_lmpc(case)
        elif case == "nl_qp_n10":
            arrays = compute_nl_qp()
        elif case in NL_CASES:
            arrays = compute_nl(case)
        elif case in MODEL_CTRL_FIXTURES:
            arrays = compute_model_ctrl(case)
        elif case in CTRL_CASES:
            arrays = compute_ctrl(case)
        elif case in ADMM_CASES:
            arrays = compute_admm(case)
        elif case in CONT_CASES:
            arrays = compute_cont(case)
        elif case == "stack":
            arrays = compute_stack()
        else:
            arrays = compute(case)
        np.savez_compressed(path, **arrays)
        print(f"wrote {path.relative_to(ROOT)}", flush=True)


if __name__ == "__main__":
    main()
