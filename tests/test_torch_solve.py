"""The whole slice: the port's batched ``RacingMPC.solve_batch`` against the
JAX package's ``jax.jit(jax.vmap(RacingMPC._solve_impl))`` on
``make_scenario_batch(..., batch=3, seed=7)`` at
``build_barc_lmpc(n_horizon=10, num_ss=16)``.

``solved`` must agree lane by lane, the longitudinal controls to 1e-3 of
``scale_u`` and the objectives to 1e-3 relative.  Steering is held against
the certified float64 optimum of each lane's QP with the repo's gates for
these shapes (tests/test_control_match.py:89-96), because at N=10 it rides a
cost-flat valley that two f32 solvers resolve differently.  Each lane of the
port's batch must also equal that lane solved alone (1e-5): that pins the
per-lane freeze of the zoom ladder.  "Alone" is a batch of copies of that
lane, of the same size: on this batch lane 2 retires from the ladder a round
before lanes 0 and 1, so it stays frozen through a round that its copies
never run.  (A batch of one is not bit-comparable: PyTorch's CPU batched
matmul rounds differently for another batch size.)
"""

import jax
import jax.numpy as jnp
import numpy as np

from racing_lmpc_torch.mpc.racing_mpc import map_input
from tests._torch_twin import (
    barc_pair, certified_controls, np_of, rel_err, scenario_pair)

N, K, BATCH, SEED = 10, 16, 3, 7


def test_solve_batch_matches_jax():
    j, t = barc_pair(N, K)
    jmpc, tmpc = j[3], t[3]
    jinp, tinp = scenario_pair(N, K, BATCH, SEED)
    jout, _ = jmpc.solve_batch(jinp, jnp.zeros((BATCH, jmpc.layout.n), jnp.float32),
                               jnp.zeros((BATCH,), bool))
    tout, z = tmpc.solve_batch(tinp)
    assert z.shape == (BATCH, tmpc.layout.n)
    for f in tout._fields:
        assert np.isfinite(np_of(getattr(tout, f))).all(), f
    assert np.array_equal(np_of(tout.solved), np_of(jout.solved))
    assert np_of(tout.solved).all()
    su = tmpc.scale_u
    Ut = np_of(tout.U_optm).astype(np.float64)
    Uj = np_of(jout.U_optm).astype(np.float64)
    assert (np.abs(Ut - Uj)[..., 0] / su[0]).max() < 1e-3
    ot, oj = np_of(tout.obj).astype(np.float64), np_of(jout.obj).astype(np.float64)
    assert (np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0)).max() < 1e-3
    with jax.default_matmul_precision("highest"):
        jdata, jaux = jax.jit(jax.vmap(jmpc._build_qp))(jinp)
    U_star, obj_star = certified_controls(jdata, jaux[2], jaux[3], su, N, tmpc.nu)
    err = np.abs(Ut - U_star) / su
    assert err[..., 0].max() < 1e-3
    assert err[..., 1].max() < 2e-1
    assert (np.abs(ot - obj_star) / np.maximum(np.abs(obj_star), 1.0)).max() < 1e-3


def test_each_lane_equals_lane_solved_alone():
    _, t = barc_pair(N, K)
    mpc = t[3]
    _, inp = scenario_pair(N, K, BATCH, SEED)
    out, _ = mpc.solve_batch(inp)
    for b in range(BATCH):
        copies, _ = mpc.solve_batch(map_input(lambda a: a[[b] * BATCH], inp))
        assert bool(copies.solved[0]) == bool(out.solved[b])
        for f in ("X_optm", "U_optm", "dU_optm", "convex_combi", "obj"):
            assert rel_err(np_of(getattr(copies, f))[0],
                           np_of(getattr(out, f))[b]) < 1e-5, (b, f)
    # the unbatched entry point runs the same solve on a batch of one
    single, z = mpc.solve(map_input(lambda a: a[0], inp))
    assert single.U_optm.shape == (N - 1, mpc.nu) and z.shape == (mpc.layout.n,)
    assert bool(single.solved)
