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

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_port_fixture.py

It writes one ``tests/data/torch_port/<case>.npz`` for each of ``CASES``.
"""

from __future__ import annotations

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


def fixture_path(case: str) -> Path:
    return FIXTURE_DIR / f"{case}.npz"


def compute(case: str) -> dict:
    """The fixture's arrays: ``inp_<field>`` (the MPCInput), the reference's
    ``U_optm``, ``obj``, ``solved``, ``r_prim``, ``r_dual``, the same
    outputs of each perturbed run stacked on a leading axis (``U_pert``,
    ``obj_pert``, ``solved_pert``), and the certified ``U_star`` /
    ``obj_star`` of each lane's condensed QP."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
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
    for case in CASES:
        path = fixture_path(case)
        np.savez_compressed(path, **compute(case))
        print(f"wrote {path.relative_to(ROOT)}", flush=True)


if __name__ == "__main__":
    main()
