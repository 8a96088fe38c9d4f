"""The port's ``RacingMPC.warm_start_vector`` and ``create_warm_start``
against the JAX package's, on the BARC LMPC and tracking configurations at
N=10 (tests/_torch_twin.py::barc_pair).  Both pack the same f32 values, so
they agree exactly (warm_start_vector) or to 1e-6 (create_warm_start, f64
on the host, rounded to f32 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_twin import barc_pair, np_of


@pytest.mark.parametrize("name", ["barc_lmpc", "barc_tracking_mpc"])
def test_warm_start_vector_matches_jax(name):
    j, t = barc_pair(10, 16, name)
    jmpc, tmpc = j[3], t[3]
    rng = np.random.default_rng(0)
    X = rng.normal(size=(10, 6)).astype(np.float32)
    U = rng.normal(size=(9, tmpc.nu)).astype(np.float32)
    dU = rng.normal(size=(9, tmpc.nu)).astype(np.float32)
    lam = rng.uniform(size=(tmpc.K,)).astype(np.float32)
    for lam_in in (lam, None, lam[:3]):
        want = jmpc.warm_start_vector(
            jnp.asarray(X), jnp.asarray(U), jnp.asarray(dU),
            None if lam_in is None else jnp.asarray(lam_in))
        got = tmpc.warm_start_vector(
            torch.as_tensor(X), torch.as_tensor(U), torch.as_tensor(dU),
            None if lam_in is None else torch.as_tensor(lam_in))
        assert np.array_equal(np_of(got), np_of(want))


def test_create_warm_start_matches_jax():
    j, t = barc_pair(10, 16)
    th = np.linspace(0, 1.5, 10)
    P0, yaws, radii = np.stack([np.cos(th), np.sin(th)], -1), th + np.pi / 2, np.full(10, 1.2)
    want = j[3].create_warm_start(P0, yaws, radii, 1.5, 2.0)
    got = t[3].create_warm_start(P0, yaws, radii, 1.5, 2.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        t[3].create_warm_start(P0, yaws, radii, 0.0, 2.0)
