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
``compute_stack``).

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
    from racing_lmpc_tpu.mpc.reference_qp import ReferenceQP, solve_dense_qp_f64

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
    with jax.default_matmul_precision("highest"):
        data, aux = jax.jit(jax.vmap(mpc._build_qp))(inp)
    P, q, A, l, u = (np.asarray(a, np.float64) for a in data)
    MU, mu0 = np.asarray(aux[2], np.float64), np.asarray(aux[3], np.float64)
    su = np.asarray(mpc.scale_u)
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
    arrays = {f"inp_{k}": np.asarray(v) for k, v in inp._asdict().items()
              if v is not None}
    arrays.update(
        U_optm=np.asarray(out.U_optm), obj=np.asarray(out.obj),
        solved=np.asarray(out.solved), r_prim=np.asarray(out.r_prim),
        r_dual=np.asarray(out.r_dual),
        U_pert=np.stack([np.asarray(o.U_optm) for o in pert]),
        obj_pert=np.stack([np.asarray(o.obj) for o in pert]),
        solved_pert=np.stack([np.asarray(o.solved) for o in pert]),
        U_star=U_star, obj_star=obj_star, scale_u=su)
    return arrays


def main() -> None:
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for case in sys.argv[1:] or [*CASES, *CTRL_CASES, *ADMM_CASES, *CONT_CASES, "stack"]:
        path = fixture_path(case)
        if case in CTRL_CASES:
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
