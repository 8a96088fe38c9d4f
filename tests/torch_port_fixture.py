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

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py [case ...]

It writes ``tests/data/torch_port/<case>.npz`` for each case named (each of
``CASES`` and ``CTRL_CASES`` when none is).
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
CTRL_CASES = {
    "ctrl_barc_lmpc": ("barc_lmpc", 20, 4, {}),
    "ctrl_putnam_short_lmpc": ("putnam_short_lmpc", 8, 4, {}),
    "ctrl_barc_lmpc_n10": ("barc_lmpc", 3, 8, SMALL),
    "ctrl_putnam_short_lmpc_n10": ("putnam_short_lmpc", 3, 8, SMALL),
}


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
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation

    cs = CoSimulation(_SCENARIOS[scenario], **cosim_kw)
    seen = []
    step = cs.controller.step

    def recording_step(x_ic, u_ic=None):
        seen.append((np.asarray(x_ic, np.float32), np.asarray(u_ic, np.float32)))
        return step(x_ic, u_ic)

    cs.controller.step = recording_step
    if move_seed is not None:
        rng = np.random.default_rng(move_seed)

        def move(msg):
            msg = copy.deepcopy(msg)
            for part, name in (("p", "s"), ("p", "x_tran"), ("p", "e_psi"),
                               ("v", "v_long"), ("v", "v_tran"), ("w", "w_psi")):
                obj = getattr(msg, part)
                setattr(obj, name, getattr(obj, name) * (1 + 2e-7 * rng.standard_normal()))
            return msg
        cs.state_filter = move
    plant = []
    for _ in range(steps):
        act = cs.controller_cycle(cs.vehicle_state_msg())
        msg = cs.plant_cycle(act)
        plant.append((msg.p.s, msg.p.x_tran, cs.lap_num))
    tel = cs.telemetry
    s, x_tran, lap = (np.asarray(v) for v in zip(*plant))
    return {"x_ctrl": np.stack([x for x, _ in seen]),
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
    for case in sys.argv[1:] or [*CASES, *CTRL_CASES]:
        path = fixture_path(case)
        arrays = compute_ctrl(case) if case in CTRL_CASES else compute(case)
        np.savez_compressed(path, **arrays)
        print(f"wrote {path.relative_to(ROOT)}", flush=True)


if __name__ == "__main__":
    main()
