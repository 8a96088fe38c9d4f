"""Why the BARC LMPC controller chain of the port's bench falls back on the
card: the cycle's ``solved`` flag against f32 rounding, the kernel and the
device.

``racing_lmpc_torch.bench.shipped_rt_latencies`` starts each launch
scenario's chain from the card's own bootstrap.  For ``barc_lmpc`` the
second cycle of that chain misses the solver's tolerance on the card
(``rd_rel`` over ``config.tol``) and keeps the previous plan.  This script
takes that start apart.  Two steps, from the repository root:

    python tests/torch_port_rti_fallback.py card [OUT]          # on the H100
    JAX_PLATFORMS=cpu python tests/torch_port_rti_fallback.py cpu [OUT]

``card`` (about five minutes with the build) bootstraps the scenario on the
card as the bench does, stores the start and the chain's per-cycle readings
(fallback, ``rp_rel``, ``rd_rel``, objective) in ``OUT/rti_fallback.npz``
(default ``chiprun_out``), and runs the two-cycle chain from that start

- with ``chol_tri_inv``'s kernel, as the bench does, and with the kernel's
  plain PyTorch version on the card (``linalg.chol_tri_inv_plain``);
- from the start as it is, and from the start with ``last_X`` and ``x0``
  moved by 1 + 2e-7 N(0, 1), about one f32 rounding (numpy seeds 1, 2, ...,
  each array from its own generator of that seed; the size of
  ``tests/torch_port_fixture.py``'s moves);

and the second cycle alone from the card's own first-cycle result (the
kernel's), moved the same way; last, that cycle's solver input as one
batch of ``RATE_COPIES`` lanes (as it is, then moved), with the kernel and
with the plain version: how often one f32 rounding of the input leaves
the solve unsolved.  ``cpu`` (about fifteen minutes) reads that file and
runs the same on the CPU: the port with the plain version and with
``linalg.chol_tri_inv_sweep`` (the kernel's own algorithm, bit-equal to the
kernel on the card), the batch with the plain version, and the JAX
package's controller and batch (no ``rd_rel`` there: its fallback,
``solved`` flag and objective).  Each run prints one line: its per-cycle
fallbacks and the largest ``rd_rel`` over the runs beside how many of
them miss the tolerance; each batch how many lanes did not solve.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SCENARIO = "barc_lmpc"
CHAIN = 2
# moved re-runs: with the kernel on the card, on the CPU, and with the
# plain version on the card (slower: a Python loop over the pivots)
MOVED, MOVED_PLAIN_CARD = 16, 8
# the copies of cycle 2's solver input solved as one batch: the input as it
# is (lane 0) and moved by numpy seeds 1 .. RATE_COPIES - 1
RATE_COPIES = 256
STATE_FIELDS = ("last_X", "last_U", "last_dU", "lam")


def moved(a: np.ndarray, seed: int | None) -> np.ndarray:
    """``a`` scaled by 1 + 2e-7 N(0, 1) from numpy seed ``seed`` (None: as
    it is), in f32."""
    if seed is None:
        return a
    rng = np.random.default_rng(seed)
    return (a * (1 + 2e-7 * rng.standard_normal(a.shape))).astype(np.float32)


def port_chain(ctrl, start: dict, seed: int | None, chain: int, device) -> list:
    """The port's ``bench.rt_chain`` from ``start`` (its ``last_X`` and
    ``x0`` moved by ``seed``): per cycle (fallback, rp_rel, rd_rel, obj)."""
    import torch
    from racing_lmpc_torch import bench
    from racing_lmpc_torch.control.loop import ControllerState

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)
    st = ControllerState(*(dev(start[f"state_{k}"]) for k in STATE_FIELDS))
    st = st._replace(last_X=dev(moved(start["state_last_X"], seed)))
    ctrl.speed_limit, ctrl.speed_scale = float(start["speed_limit"]), float(start["speed_scale"])
    _, infos = bench.rt_chain(ctrl, st, dev(moved(start["x0"], seed)), dev(start["u0"]),
                              dev(start["ss_x"]), dev(start["ss_j"]), chain)
    return [(bool(i.used_fallback), float(i.output.rp_rel), float(i.output.rd_rel),
             float(i.output.obj)) for i in infos]


def with_chol(fn):
    """A context in which the IPM takes ``fn`` for ``chol_tri_inv``."""
    import contextlib
    import racing_lmpc_torch.mpc.ipm as ipm

    @contextlib.contextmanager
    def ctx():
        old = ipm.chol_tri_inv
        ipm.chol_tri_inv = fn
        try:
            yield
        finally:
            ipm.chol_tri_inv = old
    return ctx()


def report(label: str, runs: list, tol: float) -> None:
    """One line: the unmoved run's cycles, and over all runs per cycle the
    largest rd_rel and how many runs fell back."""
    rows = np.asarray([[c[2] for c in r] for r in runs])
    fb = np.asarray([[c[0] for c in r] for r in runs])
    first = [f"({c[0]}, rd {c[2]:.3g}, obj {c[3]:.4f})" for c in runs[0]]
    print(f"{label}: unmoved {first}; over {len(runs)} runs per cycle: max rd_rel "
          f"{[f'{v:.3g}' for v in rows.max(0)]}, runs falling back {fb.sum(0).tolist()}, "
          f"rd_rel over tol {(rows >= tol).sum(0).tolist()}", flush=True)


def port_inputs(ctrl, start: dict, seeds: list, device):
    """The controller's solver input of the cycle from ``start`` (its
    ``last_X`` and ``x0`` moved by each seed), stacked as one batch:
    (MPCInput, warm starts)."""
    import torch
    from racing_lmpc_torch.control.loop import ControllerState
    from racing_lmpc_torch.mpc.racing_mpc import MPCInput

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)
    lim, sc = ctrl._f32(float(start["speed_limit"])), ctrl._f32(float(start["speed_scale"]))
    ins, zs = [], []
    for s in seeds:
        st = ControllerState(*(dev(start[f"state_{k}"]) for k in STATE_FIELDS))
        st = st._replace(last_X=dev(moved(start["state_last_X"], s)))
        inp, z, _ = ctrl.build_step_input(dev(moved(start["x0"], s)), dev(start["u0"]), st,
                                          dev(start["ss_x"]), dev(start["ss_j"]), lim, sc)
        ins.append(inp)
        zs.append(z)
    return MPCInput(*(None if f[0] is None else torch.stack(f) for f in zip(*ins))), torch.stack(zs)


def rate(label: str, rd, solved, tol: float) -> None:
    """One line: how many lanes did not solve (``rp_rel`` or ``rd_rel`` at
    or over the tolerance), lane 0's ``rd_rel`` and the spread of the
    others'."""
    rd, solved = np.asarray(rd, np.float64), np.asarray(solved, bool)
    q = np.quantile(rd[1:], [0.5, 0.9, 0.99])
    print(f"{label}: {int((~solved).sum())} of {len(rd)} lanes unsolved "
          f"({int((~solved[1:]).sum())} of the {len(rd) - 1} moved; rd_rel at or over tol "
          f"in {int((rd >= tol).sum())}); lane 0 (as it is) rd_rel {rd[0]:.3g}; moved lanes "
          f"median {q[0]:.3g}, 90% {q[1]:.3g}, 99% {q[2]:.3g}, max {rd[1:].max():.3g}",
          flush=True)


def port_rate(ctrl, start: dict, copies: int, device) -> tuple:
    """(rd_rel, solved) of ``copies`` lanes of the cycle from ``start``
    solved as one batch (``solve_batch``), lane 0 as it is."""
    import torch
    inp, z = port_inputs(ctrl, start, [None, *range(1, copies)], device)
    out, _ = ctrl.mpc.solve_batch(inp, z, torch.ones((copies,), dtype=torch.bool,
                                                     device=device))
    return out.rd_rel.cpu().numpy(), out.solved.cpu().numpy()


def card(out_dir: Path, device=None) -> None:
    import torch
    import racing_lmpc_torch  # noqa: F401  (the numerics policy)
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_torch.ops import linalg

    device = torch.device(device or "cuda")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    t0 = time.perf_counter()
    cs = CoSimulation(_SCENARIOS[SCENARIO], device=device)
    cs.step()
    ctrl = cs.controller
    st = ctrl.state
    ss_x, ss_j = ctrl._query_safe_set(st.last_X[-1])
    start = {f"state_{k}": getattr(st, k).cpu().numpy() for k in STATE_FIELDS}
    start.update(x0=st.last_X[0].cpu().numpy(), u0=np.zeros(ctrl.mpc.nu, np.float32),
                 ss_x=ss_x.cpu().numpy(), ss_j=ss_j.cpu().numpy(),
                 speed_limit=np.float32(ctrl.speed_limit),
                 speed_scale=np.float32(ctrl.speed_scale))
    tol = float(ctrl.config.tol)
    print(f"{name}; bootstrap {time.perf_counter() - t0:.1f} s, "
          f"tol {tol:g}", flush=True)

    # the card's first cycle (the kernel's): the start of cycle 2
    from racing_lmpc_torch import bench
    from racing_lmpc_torch.control.loop import ControllerState
    s1, i1 = bench.rt_chain(ctrl, ControllerState(*(torch.as_tensor(start[f"state_{k}"],
                            device=device) for k in STATE_FIELDS)),
                            torch.as_tensor(start["x0"], device=device),
                            torch.as_tensor(start["u0"], device=device), ss_x, ss_j, 1)
    second = {f"state_{k}": getattr(s1, k).cpu().numpy() for k in STATE_FIELDS}
    second.update(x0=s1.last_X[1].cpu().numpy(), u0=i1[0].u_apply.cpu().numpy(),
                  ss_x=start["ss_x"], ss_j=start["ss_j"], speed_limit=start["speed_limit"],
                  speed_scale=start["speed_scale"])

    res = {}
    for label, fn, n_moved in (("kernel", linalg.chol_tri_inv, MOVED),
                               ("plain", linalg.chol_tri_inv_plain, MOVED_PLAIN_CARD)):
        t = time.perf_counter()
        with with_chol(fn):
            runs = [port_chain(ctrl, start, s, CHAIN, device)
                    for s in [None, *range(1, n_moved + 1)]]
            report(f"card {label}, chain from the card's start", runs, tol)
            res[f"card_{label}"] = np.asarray(runs, np.float64)
            runs2 = [port_chain(ctrl, second, s, 1, device)
                     for s in [None, *range(1, n_moved + 1)]]
            report(f"card {label}, cycle 2 from the card's cycle 1", runs2, tol)
            res[f"card_{label}_second"] = np.asarray(runs2, np.float64)
        print(f"  {time.perf_counter() - t:.1f} s", flush=True)
    for label, fn in (("kernel", linalg.chol_tri_inv), ("plain", linalg.chol_tri_inv_plain)):
        with with_chol(fn):
            rd, solved = port_rate(ctrl, second, RATE_COPIES, device)
        res[f"rate_card_{label}"], res[f"rate_card_{label}_solved"] = rd, solved
        rate(f"card {label}, cycle 2 from the card's cycle 1 as one batch", rd, solved, tol)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "rti_fallback.npz", tol=tol,
             **{f"start_{k}": v for k, v in start.items()},
             **{f"second_{k}": v for k, v in second.items()}, **res)
    print(f"wrote {out_dir / 'rti_fallback.npz'}", flush=True)


def jax_chain(start: dict, seeds: list, chain: int) -> list:
    """The JAX package's controller chain (``_rti_step`` jitted as one
    scan, as ``compute_bench_rt`` runs it) from ``start``, moved by each
    seed: per cycle (fallback, NaN, NaN, obj)."""
    from tests.torch_port_fixture import _jax_on_cpu
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.control.loop import ControllerState
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation

    ctrl = CoSimulation(_SCENARIOS[SCENARIO]).controller
    ss_x, ss_j = jnp.asarray(start["ss_x"]), jnp.asarray(start["ss_j"])
    lim = jnp.asarray(start["speed_limit"], jnp.float32)
    sc = jnp.asarray(start["speed_scale"], jnp.float32)

    def steps(state, x0, u0):
        def body(carry, _):
            s, x, u = carry
            s2, info = ctrl._rti_step(x, u, s, ss_x, ss_j, lim, sc)
            return (s2, s2.last_X[1], info.u_apply), (info.used_fallback, info.output.obj)
        return jax.lax.scan(body, (state, x0, u0), None, length=chain)[1]
    f = jax.jit(steps)
    out = []
    for s in seeds:
        st = ControllerState(*(jnp.asarray(start[f"state_{k}"]) for k in STATE_FIELDS))
        st = st._replace(last_X=jnp.asarray(moved(start["state_last_X"], s)))
        fb, obj = f(st, jnp.asarray(moved(start["x0"], s)), jnp.asarray(start["u0"]))
        out.append([(bool(a), np.nan, np.nan, float(b)) for a, b in zip(fb, obj)])
    return out


def jax_rate(start: dict, copies: int) -> np.ndarray:
    """The JAX package's ``solved`` flags of ``copies`` lanes of the cycle
    from ``start`` (lane 0 as it is, the others moved), solved as one
    batch (``RacingMPC.solve_batch``)."""
    from tests.torch_port_fixture import _jax_on_cpu
    _jax_on_cpu()
    import jax.numpy as jnp
    from racing_lmpc_tpu.control.loop import ControllerState
    from racing_lmpc_tpu.launch.runner import _SCENARIOS, CoSimulation

    ctrl = CoSimulation(_SCENARIOS[SCENARIO]).controller
    lim = jnp.asarray(start["speed_limit"], jnp.float32)
    sc = jnp.asarray(start["speed_scale"], jnp.float32)
    ins, zs = [], []
    for s in [None, *range(1, copies)]:
        st = ControllerState(*(jnp.asarray(start[f"state_{k}"]) for k in STATE_FIELDS))
        st = st._replace(last_X=jnp.asarray(moved(start["state_last_X"], s)))
        inp, z, _ = ctrl.build_step_input(jnp.asarray(moved(start["x0"], s)),
                                          jnp.asarray(start["u0"]), st,
                                          jnp.asarray(start["ss_x"]), jnp.asarray(start["ss_j"]),
                                          lim, sc)
        ins.append(inp)
        zs.append(z)
    inp = type(ins[0])(*(None if f[0] is None else jnp.stack(f) for f in zip(*ins)))
    out, _ = ctrl.mpc.solve_batch(inp, jnp.stack(zs), jnp.ones((copies,), bool))
    return np.asarray(out.solved)


def cpu(out_dir: Path) -> None:
    import torch
    import racing_lmpc_torch  # noqa: F401
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_torch.ops import linalg

    with np.load(out_dir / "rti_fallback.npz") as z:
        data = {k: z[k] for k in z.files}
    tol = float(data["tol"])
    start = {k[6:]: v for k, v in data.items() if k.startswith("start_")}
    second = {k[7:]: v for k, v in data.items() if k.startswith("second_")}
    for k in [k for k in data if k.startswith("card_")]:
        report(f"stored {k}", data[k].tolist(), tol)
    for label in ("kernel", "plain"):
        rate(f"stored card {label}, cycle 2 from the card's cycle 1 as one batch",
             data[f"rate_card_{label}"], data[f"rate_card_{label}_solved"], tol)
    device = torch.device("cpu")
    ctrl = CoSimulation(_SCENARIOS[SCENARIO], device=device).controller
    seeds = [None, *range(1, MOVED + 1)]
    for label, fn in (("plain", linalg.chol_tri_inv_plain),
                      ("kernel's sweep", linalg.chol_tri_inv_sweep)):
        t = time.perf_counter()
        with with_chol(fn):
            report(f"cpu port {label}, chain from the card's start",
                   [port_chain(ctrl, start, s, CHAIN, device) for s in seeds], tol)
            report(f"cpu port {label}, cycle 2 from the card's cycle 1",
                   [port_chain(ctrl, second, s, 1, device) for s in seeds], tol)
        print(f"  {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    with with_chol(linalg.chol_tri_inv_plain):
        rate("cpu port plain, cycle 2 from the card's cycle 1 as one batch",
             *port_rate(ctrl, second, RATE_COPIES, device), tol)
    solved = jax_rate(second, RATE_COPIES)
    print(f"cpu JAX, cycle 2 from the card's cycle 1 as one batch: {int((~solved).sum())} of "
          f"{len(solved)} lanes unsolved ({int((~solved[1:]).sum())} of the "
          f"{len(solved) - 1} moved); lane 0 (as it is) solved {bool(solved[0])}", flush=True)
    print(f"  {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    for label, st in (("chain from the card's start", start),
                      ("cycle 2 from the card's cycle 1", second)):
        runs = jax_chain(st, seeds, CHAIN if st is start else 1)
        fb = np.asarray([[c[0] for c in r] for r in runs])
        print(f"cpu JAX, {label}: unmoved {[(c[0], round(c[3], 4)) for c in runs[0]]}; over "
              f"{len(runs)} runs per cycle: runs falling back {fb.sum(0).tolist()}", flush=True)
    print(f"  {time.perf_counter() - t:.1f} s", flush=True)


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    out_dir = Path(sys.argv[2]) if len(sys.argv) > 2 else ROOT / "chiprun_out"
    if mode == "card":
        card(out_dir)
    elif mode == "cpu":
        cpu(out_dir)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
