"""The port's float64 reference-QP oracle (racing_lmpc_torch/mpc/reference_qp.py)
against the JAX package's (racing_lmpc_tpu/mpc/reference_qp.py) on the
pinned accuracy instances (tests/data/acc_instances), on the CPU.

- the build from each instance's stored MPCInput: P, q, A, l, u within
  1e-12 of the JAX build (relative to each matrix's largest finite entry),
  with the same inf pattern; and within 1e-9 of the exported matrices, the
  drift guard of tests/test_reference_match.py::test_exported_qp_matches_build;
- ``kkt_residuals`` at the stored certified (z*, y*) as the JAX one's, to
  the rounding of their matrix-vector products (1e-11 of max(1, max |q|));
- ``solve_dense_qp_f64`` on a BARC LMPC and a Putnam instance: certified
  with the thresholds of test_oracle_self_certifies and within 1e-9 of the
  JAX oracle's z; and its RuntimeError on an instance made infeasible.
"""

import functools

import numpy as np
import pytest
import torch

from tests._torch_twin import acc_instances, np_of, rel_err, scenario_mpcs

INSTANCES = [i for s in ("barc_tracking_mpc", "barc_lmpc", "putnam_short_tracking_mpc")
             for i in acc_instances(s)]
IDS = [r["tag"] for r, _ in INSTANCES]
BY_TAG = dict(zip(IDS, INSTANCES))


def fields_of(d) -> dict:
    return {k[4:]: v for k, v in d.items() if k.startswith("inp_")}


@functools.cache
def jax_qp(tag: str):
    from racing_lmpc_tpu.mpc.racing_mpc import MPCInput
    from racing_lmpc_tpu.mpc.reference_qp import build_reference_qp
    rec, d = BY_TAG[tag]
    jmpc, _ = scenario_mpcs(rec["scenario"], rec["n_override"])
    return build_reference_qp(jmpc.model, jmpc.config, MPCInput(**fields_of(d)))


@functools.cache
def port_qp(tag: str):
    from racing_lmpc_torch.mpc.racing_mpc import MPCInput
    from racing_lmpc_torch.mpc.reference_qp import build_reference_qp
    rec, d = BY_TAG[tag]
    _, mpc = scenario_mpcs(rec["scenario"], rec["n_override"])
    inp = MPCInput(**{k: torch.as_tensor(v) for k, v in fields_of(d).items()})
    return build_reference_qp(mpc.model, mpc.config, inp, device="cpu")


@pytest.mark.parametrize("tag", IDS)
def test_build_matches_jax(tag):
    got, want = port_qp(tag), jax_qp(tag)
    for name in ("P", "q", "A", "l", "u"):
        err = rel_err(np_of(getattr(got, name)), getattr(want, name))
        assert err < 1e-12, f"{tag}: {name} differs from the JAX build by {err:.2e}"
    assert vars(got.layout) == vars(want.layout)
    np.testing.assert_array_equal(np_of(got.scale_x), want.scale_x)
    np.testing.assert_array_equal(np_of(got.scale_u), want.scale_u)


@pytest.mark.parametrize("tag", IDS)
def test_build_matches_export(tag):
    """The drift guard, on the port's build: each matrix within 1e-9 of the
    export relative to its largest finite entry, the same inf pattern."""
    _, d = BY_TAG[tag]
    qp = port_qp(tag)
    for name in ("P", "q", "A", "l", "u"):
        got, want = np_of(getattr(qp, name)), d[name]
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin), f"{tag}: {name} inf-pattern drift"
        scale = max(1.0, float(np.max(np.abs(want[fin]))))
        err = float(np.max(np.abs(got[fin] - want[fin]))) / scale
        assert err < 1e-9, f"{tag}: {name} drift {err:.2e}"


@pytest.mark.parametrize("tag", IDS)
def test_kkt_residuals_match_jax(tag):
    from racing_lmpc_tpu.mpc.reference_qp import kkt_residuals as jkkt
    from racing_lmpc_torch.mpc.reference_qp import kkt_residuals
    _, d = BY_TAG[tag]
    got = kkt_residuals(port_qp(tag), torch.as_tensor(d["z_star"]),
                        torch.as_tensor(d["y_star"]))
    want = jkkt(jax_qp(tag), d["z_star"], d["y_star"])
    tol = 1e-11 * max(1.0, float(np.abs(d["q"]).max()))
    for name, g, w in zip(("primal", "dual", "complementarity"), got, want):
        assert abs(g - float(w)) <= tol, f"{tag}: {name} residual {g:.3e}, JAX {w:.3e}"


@pytest.mark.parametrize("tag", ["barc_lmpc[6]", "putnam_short_tracking_mpc[8]"])
def test_oracle_certifies_and_matches_jax(tag):
    from racing_lmpc_tpu.mpc.reference_qp import solve_dense_qp_f64 as jsolve
    from racing_lmpc_torch.mpc.reference_qp import kkt_residuals, solve_dense_qp_f64
    _, d = BY_TAG[tag]
    qp = port_qp(tag)
    z, y = solve_dense_qp_f64(qp)
    rp, rd, rc = kkt_residuals(qp, z, y)
    assert rp < 1e-9 and rc < 1e-6
    assert rd / max(1.0, float(qp.q.abs().max())) < 1e-9
    zj, _ = jsolve(jax_qp(tag))
    err = rel_err(np_of(z), zj)
    assert err < 1e-9, f"{tag}: the port's oracle lies {err:.2e} from the JAX oracle's z"
    dev = (np_of(qp.controls(z)) - np_of(qp.controls(torch.as_tensor(d["z_star"])))) / d["scale_u"]
    assert np.abs(dev).max() < 1e-6


def test_oracle_raises_when_infeasible():
    """An instance made infeasible (its initial-state row repeated with
    another right-hand side) does not certify: both oracles raise."""
    from racing_lmpc_tpu.mpc.reference_qp import ReferenceQP as JQP
    from racing_lmpc_tpu.mpc.reference_qp import solve_dense_qp_f64 as jsolve
    from racing_lmpc_torch.mpc.reference_qp import ReferenceQP, solve_dense_qp_f64
    _, d = BY_TAG["barc_tracking_mpc[6]"]
    eq = np.flatnonzero(d["l"] == d["u"])[-1]
    A = np.vstack([d["A"], d["A"][eq]])
    l, u = np.append(d["l"], d["l"][eq] + 1.0), np.append(d["u"], d["u"][eq] + 1.0)
    with pytest.raises(RuntimeError, match="did not certify"):
        jsolve(JQP(P=d["P"], q=d["q"], A=A, l=l, u=u, layout=None,
                   scale_x=None, scale_u=None))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    with pytest.raises(RuntimeError, match="did not certify"):
        solve_dense_qp_f64(ReferenceQP(P=t(d["P"]), q=t(d["q"]), A=t(A), l=t(l), u=t(u),
                                       layout=None, scale_x=None, scale_u=None))
