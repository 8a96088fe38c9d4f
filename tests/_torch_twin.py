"""Shared helpers of the port tests (``tests/test_torch_*.py``).

The same inputs, made from a numpy seed, go through a function of the JAX
package (on the CPU, as ``tests/conftest.py`` sets it up) and through its
counterpart in ``racing_lmpc_torch`` (``device="cpu"``); arrays cross
between the two as numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# The port's CPU path runs many small ops; one intra-op thread per test
# worker avoids oversubscribing the cores when pytest-xdist runs workers side
# by side (with the default, a worker's small matmuls contend with the other
# workers' threads and the port tests ran ~10x slower).
torch.set_num_threads(1)


def spd(rng, B: int, n: int, cond_boost: float = 0.0) -> np.ndarray:
    """Seeded SPD batch, as ``tests/test_linalg.py::_spd`` makes it."""
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    H = np.einsum("bij,bik->bjk", A, A) + n * np.eye(n, dtype=np.float32)
    if cond_boost:
        s = 10.0 ** rng.uniform(0, cond_boost, size=(B, n)).astype(np.float32)
        H = H * s[:, :, None] * s[:, None, :]
    return H


def np_of(a) -> np.ndarray:
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def twin(jax_fn, torch_fn, *arrays):
    """Run ``jax_fn`` and ``torch_fn`` on the same numpy arrays; returns
    both results as numpy (tuples stay tuples)."""
    import jax.numpy as jnp
    j = jax_fn(*(jnp.asarray(a) for a in arrays))
    t = torch_fn(*(torch.as_tensor(a) for a in arrays))
    if isinstance(j, tuple):
        return tuple(np_of(a) for a in j), tuple(np_of(a) for a in t)
    return np_of(j), np_of(t)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the finite entries of ``want``, relative to
    max(1, max |want|); the non-finite pattern must match exactly."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), "non-finite pattern differs"
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max()
                 / max(1.0, np.abs(want[fin]).max()))


@functools.cache
def barc_pair(n_horizon: int, num_ss: int, name: str = "barc_lmpc"):
    """(JAX, port) problems of the same BARC configuration: each a
    (model, track, cfg, mpc, manager) tuple; ``name`` picks the MPC param
    file (the tracking config has no safe set)."""
    from racing_lmpc_tpu import benchmarks as jb
    from racing_lmpc_tpu.config import barc_mpc_config as jcfg
    from racing_lmpc_tpu.mpc.racing_mpc import RacingMPC as JMPC
    from racing_lmpc_torch import benchmarks as tb
    from racing_lmpc_torch.config import barc_mpc_config as tcfg
    from racing_lmpc_torch.mpc.racing_mpc import RacingMPC as TMPC

    j = jb.build_barc_lmpc(n_horizon=n_horizon, num_ss=num_ss)
    t = tb.build_barc_lmpc(n_horizon=n_horizon, num_ss=num_ss, device="cpu")
    if name != "barc_lmpc":
        jc = jcfg(name, n=n_horizon, learning=False)
        tc = tcfg(name, n=n_horizon, learning=False)
        j = (j[0], j[1], jc, JMPC(jc, j[0]), None)
        t = (t[0], t[1], tc, TMPC(tc, t[0], device="cpu"), None)
    return j, t


def scenario_pair(n_horizon: int, num_ss: int, batch: int, seed: int,
                  name: str = "barc_lmpc"):
    """The same scenario batch built by both packages: (JAX MPCInput,
    port MPCInput)."""
    from racing_lmpc_tpu.benchmarks import make_scenario_batch as jmake
    from racing_lmpc_torch.benchmarks import make_scenario_batch as tmake
    j, t = barc_pair(n_horizon, num_ss, name)
    return (jmake(j[3], j[1], j[4], batch, seed=seed),
            tmake(t[3], t[1], t[4], batch, seed=seed, device="cpu"))


def certified_controls(qp, MU, mu0, scale_u, N, nu):
    """Controls and objective of the certified float64 optimum of each lane
    of a condensed QP batch (``mpc.reference_qp.solve_dense_qp_f64``)."""
    from racing_lmpc_tpu.mpc.reference_qp import ReferenceQP, solve_dense_qp_f64
    P, q, A, l, u = (np.asarray(np_of(a), np.float64) for a in qp)
    MU, mu0 = np.asarray(np_of(MU), np.float64), np.asarray(np_of(mu0), np.float64)
    nuu = MU.shape[-1]
    Us, objs = [], []
    for b in range(P.shape[0]):
        Pb = 0.5 * (P[b] + P[b].T)
        z, _ = solve_dense_qp_f64(ReferenceQP(
            P=Pb, q=q[b], A=A[b], l=l[b], u=u[b], layout=None,
            scale_x=None, scale_u=None))
        Us.append((MU[b] @ z[:nuu] + mu0[b]).reshape(N - 1, nu) * scale_u)
        objs.append(0.5 * z @ (Pb @ z) + q[b] @ z)
    return np.stack(Us), np.asarray(objs)


def assert_same_safe_set(ss_got, j_got, ss_want, j_want, what=""):
    """Safe-set batches equal, comparing the points of a lane as sets (the
    JAX package queries through its native k-NN, the port through numpy;
    equidistant points may come back in another order)."""
    ss_got, ss_want = np.asarray(ss_got), np.asarray(ss_want)
    j_got, j_want = np.asarray(j_got), np.asarray(j_want)
    assert ss_got.shape == ss_want.shape, what
    for b in range(ss_got.shape[0]):
        if np.array_equal(ss_got[b], ss_want[b]) and np.array_equal(j_got[b], j_want[b]):
            continue
        key = lambda x, jj: sorted(map(tuple, np.concatenate(  # noqa: E731
            [x, jj[:, None]], axis=1).tolist()))
        assert key(ss_got[b], j_got[b]) == key(ss_want[b], j_want[b]), \
            f"{what} lane {b}: safe-set points differ"


# ---------------------------------------------------------------------------
# pinned accuracy instances (tests/data/acc_instances, gates in ACCURACY.json)
# ---------------------------------------------------------------------------

def acc_instances(scenario: str):
    """(manifest record, arrays) of every pinned instance of ``scenario``."""
    import json
    from pathlib import Path
    inst_dir = Path(__file__).parent / "data" / "acc_instances"
    man = json.loads((inst_dir / "manifest.json").read_text())
    out = []
    for rec in man["instances"]:
        if rec["scenario"] == scenario:
            with np.load(inst_dir / rec["file"], allow_pickle=False) as z:
                out.append((rec, {k: z[k] for k in z.files}))
    return out


@functools.cache
def scenario_mpcs(scenario: str, n: int):
    """(JAX, port) MPC of a launch scenario at horizon ``n``, each built
    through its package's ``CoSimulation`` of ``_SCENARIOS[scenario]`` at the
    shipped defaults, as tests/test_reference_match.py:87-100 builds the
    engine of a pinned instance."""
    from racing_lmpc_tpu.launch.runner import _SCENARIOS as JS, CoSimulation as JC
    from racing_lmpc_torch.launch.runner import _SCENARIOS as TS, CoSimulation as TC
    return (JC(JS[scenario], n_override=n).controller.mpc,
            TC(TS[scenario], n_override=n, device="cpu").controller.mpc)


def replay_instance(rec, d, replicas: int, gates: dict):
    """Replay one pinned instance through the port on the CPU and hold it to
    its ACCURACY.json gates, in the way tests/test_reference_match.py:179-221
    does for the JAX package.

    The applied steering of these instances rides a cost-flat valley whose
    f32 resolution depends on rounding: perturbing the inputs by one f32
    rounding moves the JAX package's own applied-steer error on barc_lmpc[6]
    between 3e-5 and 2e-2 (measured).  So the instance is solved as a batch
    of ``replicas`` copies, the first exact and the rest with x_ic and X_ref
    perturbed by ~2e-7 relative (``racing_lmpc_torch.tools.accuracy.
    acc_copies``); every copy must converge, meet the longitudinal and
    feasibility gates, and the MEDIAN over the copies must meet the steering
    and objective-gap gates.  The vehicle and the config are the instance's
    scenario's (``scenario_mpcs``); the reference QP is
    the JAX package's build.
    """
    from racing_lmpc_tpu.mpc.racing_mpc import MPCInput as JInput
    from racing_lmpc_tpu.mpc.reference_qp import build_reference_qp
    from racing_lmpc_torch.carry import mpc_input_from_arrays
    from racing_lmpc_torch.tools.accuracy import acc_copies, acc_fields

    jmpc, mpc = scenario_mpcs(rec["scenario"], rec["n_override"])

    fields = acc_fields(d)
    out, _ = mpc.solve_batch(mpc_input_from_arrays(acc_copies(d, replicas),
                                                   device="cpu"))
    tag = rec["tag"]
    assert np_of(out.solved).all(), f"{tag}: not every copy converged"

    su = d["scale_u"]
    N, nx, nu = d["inp_X_ref"].shape[0], 6, len(su)
    z = d["z_star"]
    U_star = z[N * nx:N * nx + (N - 1) * nu].reshape(N - 1, nu) * su
    rel = np.abs(np_of(out.U_optm).astype(np.float64) - U_star) / su
    assert rel[..., 0].max() < 1e-3, f"{tag} lon {rel[..., 0].max():.2e}"
    applied = np.median(rel[:, :2, 1].max(-1))
    assert applied < gates["applied_steer_gate"], \
        f"{tag} applied steer median {applied:.2e} > {gates['applied_steer_gate']:.2e}"
    tail_gate = 2e-2 if rec["learning"] else 1e-2
    tail = np.median(rel[..., 1].max(-1))
    assert tail < tail_gate, f"{tag} steer tail median {tail:.2e}"

    # quality: each copy's primal packed into the reference QP's variables
    qp = build_reference_qp(jmpc.model, jmpc.config, JInput(**fields))
    L = qp.layout
    gaps = []
    for r in range(replicas):
        zr = np.zeros(L.n)
        X = np_of(out.X_optm[r]).astype(np.float64)
        zr[:L.u_off] = (X / qp.scale_x[None, :]).reshape(-1)
        zr[L.u_off:L.du_off] = (np_of(out.U_optm[r]).astype(np.float64)
                                / qp.scale_u[None, :]).reshape(-1)
        zr[L.du_off:L.du_off + (L.N - 1) * L.nu] = (
            np_of(out.dU_optm[r]).astype(np.float64) / qp.scale_u[None, :]).reshape(-1)
        if L.has_bslack:
            zr[L.sb_off] = max(float(out.boundary_slack[r]), 0.0)
        if L.learning:
            lam = np_of(out.convex_combi[r]).astype(np.float64)
            zr[L.lam_off:L.lam_off + L.K] = lam
            if L.has_hull_slack:
                zr[L.hs_off:L.hs_off + L.nx] = X[-1] - fields["ss_x"].astype(np.float64).T @ lam
        Az = qp.A @ zr
        viol = max(float(np.max(Az - qp.u, initial=0.0)),
                   float(np.max(qp.l - Az, initial=0.0)))
        assert viol < 5e-4, f"{tag} copy {r}: infeasible in the reference QP by {viol:.2e}"
        gaps.append((qp.objective(zr) - qp.objective(z))
                    / max(abs(qp.objective(z)), 1.0))
    assert min(gaps) > -1e-6, f"{tag}: beat the certified optimum by {min(gaps):.2e}"
    gap = float(np.median(gaps))
    assert gap < gates["obj_gap_gate"], \
        f"{tag}: objective gap median {gap:.3e} > {gates['obj_gap_gate']:.3e}"


# ---------------------------------------------------------------------------
# the controller cycle against stored reference runs (tests/data/torch_port/
# ctrl_*.npz, written by tests/torch_port_fixture.py)
# ---------------------------------------------------------------------------

def controller_case(case: str) -> tuple[dict, dict]:
    """The port's controller fed the first stored reference run of ``case``
    (teacher forcing, on the CPU), read against that run with
    ``chip_smoke.py``'s controller gates (and its regression gates where
    the case runs the error-dynamics regression; a continuous co-simulation
    case of ``CONT_CASES`` builds the controller in continuous mode).
    Returns (reading, limits)."""
    import chip_smoke
    from tests import torch_port_fixture as tf
    if case in tf.CONT_CASES:
        scenario, ticks, moved, _, kw = tf.CONT_CASES[case]
        kw = {**kw, "continuous": True}
    else:
        scenario, steps, moved, kw = tf.CTRL_CASES[case]
    with np.load(tf.fixture_path(case)) as z:
        fx = {k: z[k] for k in z.files}
    assert len(fx["x_ctrl"]) == moved + 1
    if case in tf.CTRL_CASES:
        assert fx["x_ctrl"].shape[1] == steps
    port = chip_smoke.teacher_forced(scenario, fx, 0, "cpu", **kw)
    reading = chip_smoke.ctrl_reading(port, chip_smoke.ctrl_runs(fx)[0], fx["scale_u"])
    limits = chip_smoke.ctrl_limits(fx)
    if "dA" in fx:
        reading.update(chip_smoke.reg_reading(port, fx, 0))
        limits.update(chip_smoke.reg_limits(fx))
    return reading, limits
