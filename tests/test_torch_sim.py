"""The port's plant simulator (racing_lmpc_torch/sim/simulator.py), the
single-track model's base-control conversions and the angle helpers it
uses, against the JAX package's on seeded states and controls.

Tolerances: one step of the same f32 dynamics through an eager and a fused
(XLA) evaluation agrees to 1e-5 relative to the state's scale, and so does
a 10-step rollout at BARC's control ranges; the conversions are elementwise
and agree to 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import racing_lmpc_tpu.config as jc
from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
from racing_lmpc_tpu.ops.math import align_yaw as jalign_yaw, lateral_sign as jlateral
from racing_lmpc_tpu.sim import RacingSimulator as JSim
from racing_lmpc_tpu.track import RacingTrajectory as JTrack
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.ops.math import align_yaw, lateral_sign
from racing_lmpc_torch.sim import RacingSimulator
from racing_lmpc_torch.track import RacingTrajectory
from tests._torch_twin import rel_err, twin

TRACK = tc.TRACK_DIR / "barc" / "02_barc_center.txt"


def models(use_frenet: bool, vehicle: str = "barc"):
    files = (f"{vehicle}_base.param.yaml", f"{vehicle}_single_track.param.yaml")
    out = []
    for c, M in ((jc, JModel), (tc, SingleTrackPlanarModel)):
        p = c.load_ros_params(*(c.PARAM_DIR / f for f in files))
        base = c.vehicle_config_from_params(p)
        base = dataclasses.replace(
            base, modeling=dataclasses.replace(base.modeling, use_frenet=use_frenet))
        out.append(M(base, c.single_track_config_from_params(p)))
    return out


def test_angle_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-20, 20, 200).astype(np.float32) for _ in range(2))
    j, t = twin(jalign_yaw, align_yaw, a, b)
    assert rel_err(t, j) < 1e-6
    pos = rng.normal(size=(200, 2)).astype(np.float32)
    pose = rng.normal(size=(200, 3)).astype(np.float32)
    j, t = twin(jlateral, lateral_sign, pos, pose)
    assert np.array_equal(t, j)


@pytest.mark.parametrize("vehicle", ["barc", "iac_car"])
def test_base_control_round_trip_matches_jax(vehicle):
    jm, tm = models(True, vehicle)
    assert tm.nu_base == jm.nu_base == 3
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    u = (rng.normal(size=(50, tm.nu)) * 3).astype(np.float32)
    j, t = twin(jm.to_base_control, tm.to_base_control, x, u)
    assert rel_err(t, j) < 1e-6
    j2, t2 = twin(jm.from_base_control, tm.from_base_control, x, j)
    assert rel_err(t2, j2) < 1e-6
    assert np.array_equal(tm.to_base_state(torch.as_tensor(x), None).numpy(), x)


@pytest.mark.parametrize("use_frenet", [False, True])
def test_simulator_steps_match_jax(use_frenet):
    jm, tm = models(use_frenet)
    cfg_j = jc.SimulatorConfig(dt=0.025, x0=(1.0, 0.0, 0.0, 1.5, 0.0, 0.0))
    cfg_t = tc.SimulatorConfig(dt=0.025, x0=(1.0, 0.0, 0.0, 1.5, 0.0, 0.0))
    js = JSim(cfg_j, jm, JTrack.from_file(TRACK))
    ts = RacingSimulator(cfg_t, tm, RacingTrajectory.from_file(TRACK, device="cpu"),
                         device="cpu")
    rng = np.random.default_rng(2)
    # BARC's base controls: drive and brake force (kN), steering (rad)
    us = np.stack([rng.uniform(0, 0.02, 40), rng.uniform(-0.02, 0, 40),
                   rng.uniform(-0.3, 0.3, 40)], -1).astype(np.float32)
    for u in us:
        ts.set_state(np.asarray(js.x))      # one step of each from one state
        js.step(jnp.asarray(u))
        ts.step(u)
        assert rel_err(ts.x.numpy(), np.asarray(js.x)) < 1e-5
    # one batched step from states that hit the |vx| clamp and the wraps,
    # then a batched rollout across the start/finish line and yaw = pi
    x0 = np.array([[16.9, 0.1, 3.1, 0.0, 0.0, 0.0], [0.1, -0.1, -3.1, -1e-8, 0.1, 0.5]],
                  np.float32)
    j, t = twin(js.step_fn, ts.step_fn, x0, us[:2])
    assert rel_err(t, j) < 1e-5
    x0[:, 3] = (1.5, 2.0)
    U = np.broadcast_to(us[:10], (2, 10, 3)).copy()
    got = ts.rollout(torch.as_tensor(x0), torch.as_tensor(U)).numpy()
    want = np.asarray(js.rollout(jnp.asarray(x0), jnp.asarray(U)))
    assert got.shape == want.shape == (2, 10, 6)
    assert rel_err(got, want) < 1e-5
