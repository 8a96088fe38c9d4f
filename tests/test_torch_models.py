"""Port models and math (racing_lmpc_torch/models, ops/math.py,
ops/integrators.py) against the JAX package on seeded batches.

Tolerance 1e-5 relative: both sides evaluate the same f32 expressions, but
their transcendental functions (tanh, atan, sin, cos) round differently in
the last bits, which the RK4 Jacobian chain carries to ~1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import racing_lmpc_tpu.config as jc
import racing_lmpc_torch.config as tc
from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
from racing_lmpc_tpu.ops import integrators as ji, math as jm
from racing_lmpc_torch.models import SingleTrackPlanarModel as TModel
from racing_lmpc_torch.ops import integrators as ti, math as tm
from tests._torch_twin import rel_err, twin


def _models(simplify: bool):
    jb, js = jc.barc_vehicle()
    tb, ts = tc.barc_vehicle()
    return (JModel(jb, dataclasses.replace(js, simplify_lon_control=simplify)),
            TModel(tb, dataclasses.replace(ts, simplify_lon_control=simplify)))


def _states(rng, B, nu):
    x = np.stack([rng.uniform(0, 17, B), rng.uniform(-0.3, 0.3, B),
                  rng.uniform(-0.3, 0.3, B), rng.uniform(0.5, 2.5, B),
                  rng.uniform(-0.2, 0.2, B), rng.uniform(-1, 1, B)], -1)
    if nu == 2:
        u = np.stack([rng.uniform(-0.01, 0.01, B), rng.uniform(-0.3, 0.3, B)], -1)
    else:
        u = np.stack([rng.uniform(0, 10, B), rng.uniform(-10, 0, B),
                      rng.uniform(-0.3, 0.3, B)], -1)
    k = rng.uniform(-1, 1, B)
    dt = np.full(B, 0.025)
    return [a.astype(np.float32) for a in (x, u, k, dt)]


@pytest.mark.parametrize("simplify", [True, False])
def test_discrete_jacobian_matches_jax(simplify):
    jm_, tm_ = _models(simplify)
    x, u, k, dt = _states(np.random.default_rng(0), 64, tm_.nu)
    (Aj, Bj, gj), (At, Bt, gt) = twin(
        jax.vmap(jm_.discrete_dynamics_jacobian), tm_.discrete_dynamics_jacobian,
        x, u, k, dt)
    for got, want in ((At, Aj), (Bt, Bj), (gt, gj)):
        assert got.dtype == np.float32
        assert rel_err(got, want) < 1e-5
    # any leading batch shape
    A2, _, _ = tm_.discrete_dynamics_jacobian(
        *(torch.as_tensor(a).reshape((8, 8) + a.shape[1:]) for a in (x, u, k, dt)))
    assert np.array_equal(A2.reshape(64, 6, 6).numpy(), At)


def test_to_base_state_jacobian_matches_jax():
    """``VehicleModel.to_base_state_jacobian`` (base.py:147-152) of the
    single-track model, whose base state is its own: (I, 0)."""
    jm_, tm_ = _models(True)
    x, u, _, _ = _states(np.random.default_rng(3), 16, tm_.nu)
    (Jxj, Juj), (Jxt, Jut) = twin(jax.vmap(jm_.to_base_state_jacobian),
                                  tm_.to_base_state_jacobian, x, u)
    assert Jxt.dtype == Jut.dtype == np.float32
    assert np.array_equal(Jxt, Jxj) and np.array_equal(Jut, Juj)
    assert np.array_equal(Jxt, np.broadcast_to(np.eye(6, dtype=np.float32), (16, 6, 6)))


@pytest.mark.parametrize("simplify", [True, False])
def test_dynamics_and_integrators_match_jax(simplify):
    jm_, tm_ = _models(simplify)
    x, u, k, dt = _states(np.random.default_rng(1), 32, tm_.nu)
    fj, ft = twin(jm_.dynamics, tm_.dynamics, x, u, k)
    assert rel_err(ft, fj) < 1e-5
    for method in ("rk4", "euler"):
        j = jax.vmap(lambda *a: ji.integrate(jm_.dynamics, *a, method=method))
        nj, nt = twin(j, lambda *a: ti.integrate(tm_.dynamics, *a, method=method),
                      x, u, k, dt)
        assert rel_err(nt, nj) < 1e-5
    bj, bt = jm_.control_bounds(), tm_.control_bounds()
    for f in ("u_lb", "u_ub", "du_lb", "du_ub"):
        assert np.array_equal(getattr(bj, f), getattr(bt, f))
    assert tm_.cost_state_indices() == jm_.cost_state_indices()


def test_math_ops_match_jax():
    rng = np.random.default_rng(2)
    s1 = rng.uniform(-40, 40, 200).astype(np.float32)
    s2 = rng.uniform(-40, 40, 200).astype(np.float32)
    L = np.full(200, 17.014, np.float32)
    aj, at = twin(jm.align_abscissa, tm.align_abscissa, s1, s2, L)
    assert rel_err(at, aj) < 1e-6
    assert np.all(np.abs(at - s2) <= L / 2 + 1e-4)
    wj, wt = twin(jm.wrap_to_pi, tm.wrap_to_pi, 10 * s1)
    assert rel_err(wt, wj) < 1e-6
