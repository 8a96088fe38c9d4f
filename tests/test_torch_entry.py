"""The port's ``entry()`` (racing_lmpc_torch/entry.py), the twin of
``__graft_entry__.entry``, on the CPU: its example arguments have the JAX
entry's shapes, its ``fn`` gives the controls of the port's own
``solve_batch`` lane to the bit, and it is held to the flagship batch's
gates (chip_smoke.py) against the stored JAX runs of the same solve
(tests/data/torch_port/entry_barc_n20_k48.npz, tests/torch_port_fixture.py).
"""

import functools

import numpy as np
import pytest
import torch

from tests._torch_twin import np_of


@functools.cache
def port_entry():
    from racing_lmpc_torch.entry import entry
    return entry(device="cpu")


@functools.cache
def port_problem():
    """The entry's problem built again: its MPC and its one-lane batch."""
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon=20, num_ss=48, device="cpu")
    return mpc, make_scenario_batch(mpc, track, manager, batch=1, device="cpu")


def test_entry_args_match_jax_entry():
    import __graft_entry__
    _, (jinp, jz, jvalid) = __graft_entry__.entry()
    _, (inp, z, valid) = port_entry()
    for name, a in jinp._asdict().items():
        b = getattr(inp, name)
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == tuple(a.shape), name
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_allclose(np_of(b), np.asarray(a), rtol=1e-6, atol=1e-6, err_msg=name)
    assert tuple(z.shape) == jz.shape and not z.any()
    assert tuple(valid.shape) == jvalid.shape == () and bool(valid)


def test_entry_equals_solve_batch_lane():
    fn, args = port_entry()
    U = fn(*args)
    mpc, inp = port_problem()
    out, _ = mpc.solve_batch(inp)
    assert tuple(U.shape) == (mpc.N - 1, mpc.nu)
    assert bool(torch.isfinite(U).all())
    assert torch.equal(U, out.U_optm[0])


def test_entry_meets_flagship_gates():
    """The entry's solve and its 8 moved copies held, as chip_smoke.py holds
    the flagship batch, to the reference's spread over its 9 stored runs
    of the same solve (the first is __graft_entry__.entry()'s own)."""
    import chip_smoke
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS
    fx = chip_smoke.load_batch_fixture(chip_smoke.ENTRY_CASE)
    np.testing.assert_array_equal(fx["U_entry"], fx["U_optm"])
    fn, args = port_entry()
    mpc, inp = port_problem()
    for name in REQUIRED_FIELDS:
        np.testing.assert_allclose(np_of(getattr(inp, name)), fx[f"inp_{name}"],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    first, _ = mpc.solve_batch(inp)
    assert torch.equal(fn(*args), first.U_optm[0])
    limits = chip_smoke.gate_limits(fx)
    failed = chip_smoke.held_to_reference(
        chip_smoke.runs_like_reference(mpc, inp, fx, first=first), fx, limits, "entry")
    assert not failed, f"entry outside the reference's own spread on {failed}"


def test_new_entry_points_default_to_cuda():
    """``entry``, the oracle's build and OSQP on arrays run on CUDA unless
    the caller names the CPU; without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from racing_lmpc_torch.entry import entry
    from racing_lmpc_torch.mpc import osqp_ref
    from racing_lmpc_torch.mpc.reference_qp import build_reference_qp
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    mpc, inp = port_problem()
    one = type(inp)(*(None if a is None else a[0] for a in inp))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_reference_qp(mpc.model, mpc.config, one)
    assert build_reference_qp(mpc.model, mpc.config, one, device="cpu").P.device.type == "cpu"
    arrays = (np.eye(2), np.ones(2), np.eye(2), -np.ones(2), np.ones(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        osqp_ref.solve(*arrays)
    assert osqp_ref.solve(*arrays, device="cpu").x.device.type == "cpu"
