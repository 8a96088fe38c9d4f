"""MPC control-loop orchestration: one controller cycle at batch 1.

Port of ``racing_lmpc_tpu/control/loop.py`` (parity target
``racing_mpc_node.cpp`` on_step_timer, :150-477):

- **bootstrap**: before the first plan, roll the state forward with ~zero
  control and run the SQP loop ``RacingMPC.solve_sqp`` (:210-235);
- **RTI reference = shifted previous plan**: each cycle shifts
  last_X/last_U/last_dU one stage, closes the horizon through the composed
  discrete dynamics and uses the result as cost reference and linearization
  point; bounds, curvature and speed come from the track at the shifted
  abscissae, the speed reference clipped around the current speeds
  (:236-292);
- with ``sqp_relin_steps > 1`` the cycle re-linearizes around the nonlinear
  rollout of the accepted controls and re-solves, damped by 0.5, until the
  applied stages converge (``loop.py:239-289``).  The reference's
  ``lax.while_loop`` is a Python loop here with one host read of ``active``
  per round, and keeps its semantics: round 0 solves at the shifted
  reference and is always kept, ``active`` is forced on after it, a failed
  re-solve keeps the previous iterate, and ``dU_optm`` is the undamped
  re-solve's while ``U_optm`` is damped;
- on a failed solve the shifted previous plan keeps flying.

Everything of the cycle runs on the controller's device (CUDA unless the
caller names one); the safe-set query and the lap recorder run on the host
between shift and solve, as the reference queries its safe set inside
``RacingMPC::solve``.  With a ``RegressionSpec`` the cycle also makes one
multi-group error-dynamics regression query around the current state and
control (``SafeSetManager.query_regression``: the prediction sweep on the
device, the fit on the host), whose (dA, dB, dC) enter the cycle's
``MPCInput`` (``loop.py:45-57``, ``:424-453``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import RacingMPCConfig
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.mpc.racing_mpc import MPCInput, MPCOutput, RacingMPC
from racing_lmpc_torch.safeset import RegQuery, SafeSetManager, SafeSetRecorder
from racing_lmpc_torch.track.trajectory import RacingTrajectory


class RegressionSpec(NamedTuple):
    """Opt-in local error-dynamics regression (arXiv:2309.10716 §III-B;
    ``loop.py:45-57``): each group fits the one-step prediction error of ONE
    output state from selected state/control inputs around the current
    operating point; the (dA, dB, dC) corrections enter the stage
    linearization, constant over the horizon."""
    dist_max: float
    # each group: (in_state_idxs, in_control_idxs, out_state_idx)
    groups: tuple


class ControllerState(NamedTuple):
    # the next cycle's shifted reference (racing_mpc_node.cpp:248-258)
    last_X: Tensor    # (N, nx) previous optimal states
    last_U: Tensor    # (N-1, nu)
    last_dU: Tensor   # (N-1, nu)
    lam: Tensor       # (K,) previous convex combination


class StepInfo(NamedTuple):
    output: MPCOutput
    u_apply: Tensor        # model control applied this cycle
    u_base: Tensor         # base (fd, fb, steer) actuation published
    used_fallback: Tensor  # bool: the previous plan kept after a failed solve


class MPCController:
    def __init__(self, config: RacingMPCConfig, model: VehicleModel,
                 track: RacingTrajectory, dt: float,
                 safe_set_query: Callable | None = None,
                 regression: RegressionSpec | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.model = model
        self.track = track
        self.dt = dt
        self.regression = regression
        self._dt = torch.tensor(dt, dtype=torch.float32, device=self.device)
        self.mpc = RacingMPC(config, model, device=self.device)
        self.safe_set_query = safe_set_query
        # applied-command pick u[delay_step] (racing_mpc_node.cpp:386-402);
        # config -1 = mode default
        self.delay_step = (config.delay_step if config.delay_step >= 0
                           else (1 if config.step_mode == "continuous" else 0))
        x_max = np.asarray(config.x_max) if len(config.x_max) == model.nx else None
        self.speed_limit = (float(x_max[self.mpc.idx_vel]) if x_max is not None
                            else np.inf)
        self.speed_scale = 1.0
        self.state: ControllerState | None = None

        # LMPC safe set, at the loop level as in the reference
        # (racing_mpc.cpp:56-60,240-277)
        self.ss_manager = None
        self.ss_recorder = None
        self._ss_loaded = False
        self._time = 0.0
        if config.learning and safe_set_query is None:
            self.ss_manager = SafeSetManager(config.max_lap_stored, nx=model.nx,
                                             nu=model.nu)
            self.ss_recorder = SafeSetRecorder(
                self.ss_manager, to_file=config.record,
                file_prefix=config.path_prefix)

    def _f32(self, a) -> Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------
    def _composed_step(self, x: Tensor, u: Tensor) -> Tensor:
        """Model discrete dynamics with the track curvature composed in, the
        node's ``discrete_dynamics_`` (racing_mpc_node.cpp:46-50)."""
        k = (self.track.curvature(x[..., 0])
             if self.model.base_config.modeling.use_frenet
             else torch.zeros_like(x[..., 0]))
        return self.model.discrete_dynamics(x, u, k, self._dt)

    def _reference_arrays(self, X_ref: Tensor):
        """Bounds, curvature and raw speed at the horizon's abscissae
        (racing_mpc_node.cpp:260-268)."""
        s = X_ref[:, 0]
        return (self.track.left_boundary(s), self.track.right_boundary(s),
                self.track.curvature(s), self.track.velocity(s))

    def _clip_vel_ref(self, vel_raw: Tensor, current_speeds: Tensor,
                      speed_limit: Tensor, speed_scale: Tensor) -> Tensor:
        """Speed reference clipping (racing_mpc_node.cpp:269-286); clip is
        minimum(maximum(.)), as ``jnp.clip``."""
        d = self.config.max_vel_ref_diff
        lo, hi = current_speeds - d, current_speeds + d
        ref = vel_raw * speed_scale
        limit_clipped = torch.minimum(torch.maximum(speed_limit, lo), hi)
        ref_clipped = torch.minimum(torch.minimum(torch.maximum(ref, lo), hi),
                                    limit_clipped)
        return torch.where(ref > 0.0, ref_clipped, limit_clipped)

    # ------------------------------------------------------------------
    def build_step_input(self, x_ic: Tensor, u_ic: Tensor,
                         state: ControllerState, ss_x: Tensor, ss_j: Tensor,
                         speed_limit: Tensor, speed_scale: Tensor, regs=None
                         ) -> tuple[MPCInput, Tensor, Tensor]:
        """Shift the previous plan and assemble this cycle's solver input
        (racing_mpc_node.cpp:236-292), with the regression's (dA, dB, dC)
        when ``regs`` carries them.  Returns (inp, z_warm, dU_ref)."""
        mpc = self.mpc
        N, nu = mpc.N, mpc.nu
        # continuous mode: predict one step ahead with the in-flight command
        if self.config.step_mode == "continuous":
            x_ic = self._composed_step(x_ic, state.last_U[0])
        X_term = self._composed_step(state.last_X[-1], state.last_U[-1])
        X_ref = torch.cat([state.last_X[1:], X_term[None]], dim=0)
        U_ref = torch.cat([state.last_U[1:], state.last_U[-1:]], dim=0)
        dU_ref = torch.cat([state.last_dU[1:], state.last_dU.new_zeros((1, nu))], dim=0)
        bl, br, curv, vel_raw = self._reference_arrays(X_ref)
        vel_ref = self._clip_vel_ref(vel_raw, X_ref[:, mpc.idx_vel],
                                     speed_limit, speed_scale)
        inp = MPCInput(
            x_ic=x_ic, u_ic=u_ic, X_ref=X_ref, U_ref=U_ref,
            T_ref=self._dt.expand(N - 1).clone(),
            bound_left=bl, bound_right=br,
            total_length=self._f32(self.track.total_length),
            curvatures=curv, vel_ref=vel_ref, ss_x=ss_x, ss_j=ss_j,
            **({} if regs is None else dict(zip(("dA", "dB", "dC"), regs))))
        z_warm = mpc.warm_start_vector(X_ref, U_ref, dU_ref, state.lam)
        return inp, z_warm, dU_ref

    def _nl_rollout(self, x0: Tensor, U: Tensor) -> Tensor:
        """Nonlinear rollout of a control plan through the composed discrete
        dynamics (curvature at each state's own abscissa)."""
        xs = [x0]
        for u in U:
            xs.append(self._composed_step(xs[-1], u))
        return torch.stack(xs)

    def _sqp_solve(self, inp: MPCInput, z_warm: Tensor, speed_limit: Tensor,
                   speed_scale: Tensor) -> MPCOutput:
        """The in-loop SQP re-linearization of ``loop.py:239-289``."""
        mpc = self.mpc
        su = mpc._c["su"]
        n_steps = max(1, self.config.sqp_relin_steps)
        # round 0 solves at the shifted reference and is always kept;
        # ``active`` is forced on after it, as in the reference
        prev, _ = mpc.solve(inp, z_warm)
        it, active = 1, True
        while active and it < n_steps:
            U = prev.U_optm
            X_roll = self._nl_rollout(inp.x_ic, U)
            bl, br, curv, vel_raw = self._reference_arrays(X_roll)
            vel_r = self._clip_vel_ref(vel_raw, X_roll[:, mpc.idx_vel],
                                       speed_limit, speed_scale)
            out_r, _ = mpc.solve(inp._replace(
                X_ref=X_roll, U_ref=U, bound_left=bl, bound_right=br,
                curvatures=curv, vel_ref=vel_r), z_warm)
            # damped controls and their rollout; dU_optm stays the undamped
            # re-solve's, as in the reference
            U_new = U + 0.5 * (out_r.U_optm - U)
            cand = out_r._replace(U_optm=U_new,
                                  X_optm=self._nl_rollout(inp.x_ic, U_new))
            # a failed re-solve keeps the previous iterate
            prev = MPCOutput(*(torch.where(out_r.solved, a, b)
                               for a, b in zip(cand, prev)))
            # convergence on the applied stages; a failed re-solve stops
            du = torch.max(torch.abs(U_new[:4] - U[:4]) / su)
            active = bool(out_r.solved & (du >= self.config.sqp_relin_tol))
            it += 1
        return prev

    def _rti_step(self, x_ic: Tensor, u_ic: Tensor, state: ControllerState,
                  ss_x: Tensor, ss_j: Tensor, speed_limit: Tensor,
                  speed_scale: Tensor, regs=None) -> tuple[ControllerState, StepInfo]:
        mpc = self.mpc
        inp, z_warm, dU_ref = self.build_step_input(
            x_ic, u_ic, state, ss_x, ss_j, speed_limit, speed_scale, regs)
        if self.config.sqp_relin_steps > 1:
            out = self._sqp_solve(inp, z_warm, speed_limit, speed_scale)
        else:
            out, _ = mpc.solve(inp, z_warm)

        # on failure keep flying the shifted previous plan
        ok = out.solved
        new_state = ControllerState(
            torch.where(ok, out.X_optm, inp.X_ref),
            torch.where(ok, out.U_optm, inp.U_ref),
            torch.where(ok, out.dU_optm, dU_ref),
            torch.where(ok, out.convex_combi, state.lam)
            if self.config.learning else state.lam)
        u_apply = new_state.last_U[self.delay_step]
        x_apply = new_state.last_X[self.delay_step]
        return new_state, StepInfo(
            output=out, u_apply=u_apply,
            u_base=self.model.to_base_control(x_apply, u_apply),
            used_fallback=~ok)

    # ------------------------------------------------------------------
    def bootstrap(self, x_ic: Tensor, sqp_iters: int = 8) -> ControllerState:
        """First-plan bootstrap (racing_mpc_node.cpp:210-235): roll the state
        forward with ~zero control, then SQP to a feasible plan."""
        mpc = self.mpc
        N, nu = mpc.N, mpc.nu
        x_ic = self._f32(x_ic)
        U0 = torch.full((N - 1, nu), 1e-9, dtype=torch.float32, device=self.device)
        X0 = self._nl_rollout(x_ic, U0)
        bl, br, curv, vel_raw = self._reference_arrays(X0)
        vel_ref = self._clip_vel_ref(vel_raw, X0[:, mpc.idx_vel],
                                     self._f32(self.speed_limit),
                                     self._f32(self.speed_scale))
        ss_x, ss_j = self._query_safe_set(X0[-1])
        inp = MPCInput(
            x_ic=x_ic, u_ic=x_ic.new_zeros((nu,)), X_ref=X0, U_ref=U0,
            T_ref=self._dt.expand(N - 1).clone(),
            bound_left=bl, bound_right=br,
            total_length=self._f32(self.track.total_length),
            curvatures=curv, vel_ref=vel_ref, ss_x=ss_x, ss_j=ss_j)
        out, _ = mpc.solve_sqp(inp, iters=sqp_iters)
        lam = out.convex_combi if self.config.learning else x_ic.new_zeros((0,))
        self.state = ControllerState(out.X_optm, out.U_optm, out.dU_optm, lam)
        return self.state

    def _query_safe_set(self, x_terminal: Tensor) -> tuple[Tensor, Tensor]:
        """Fixed-K safe-set query on the host (racing_mpc.cpp:249-277).  With
        no lap stored yet the terminal hull is pinned at the terminal
        reference, as the reference does."""
        K, nx = self.mpc.K, self.mpc.nx
        if not self.config.learning:
            return (torch.zeros((K, nx), device=self.device),
                    torch.zeros((K,), device=self.device))
        x_t = x_terminal.cpu().numpy()
        if self.safe_set_query is not None:
            ss_x, ss_j = self.safe_set_query(x_t, K)
        else:
            ss_x, ss_j, found = self.ss_manager.query_padded(
                x_t, K, self.config.num_ss_pts_per_lap)
            if not found:
                ss_x = np.tile(x_t, (K, 1))
                ss_j = np.zeros(K, dtype=np.float32)
        return self._f32(ss_x), self._f32(ss_j)

    def change_trajectory(self, new_track: RacingTrajectory):
        """Raceline hot swap with the stored plan re-projected old Frenet ->
        global -> new Frenet (racing_mpc_node.cpp:509-571)."""
        if self.state is not None:
            X = self.state.last_X
            pose_g = self.track.frenet_to_global(X[:, :3])
            s_seed = new_track.nearest_waypoint_abscissa(pose_g[:, :2])
            pose_f = new_track.global_to_frenet(pose_g, s_seed)
            self.state = self.state._replace(
                last_X=torch.cat([pose_f, X[:, 3:]], dim=-1))
        self.track = new_track

    def on_trajectory_command(self, cmd, track_map=None):
        """Apply a ``TrajectoryCommand``: raceline switch through the map,
        speed limit, speed-profile scale (racing_mpc_node.cpp:131-148,
        479-507,573-598).  An unknown raceline index is ignored."""
        if track_map is not None and cmd.trajectory_index >= 0:
            tr = track_map.trajectories.get(int(cmd.trajectory_index))
            if tr is not None and tr is not self.track:
                self.change_trajectory(tr)
        if cmd.speed_limit > 0.0:
            self.speed_limit = float(cmd.speed_limit)
        if cmd.velocity_profile_scale > 0.0:
            self.speed_scale = float(cmd.velocity_profile_scale)

    def step(self, x_ic, u_ic=None) -> StepInfo:
        """One control cycle.  ``x_ic`` is the current model state (Frenet),
        ``u_ic`` the previously applied model control (host arrays or
        tensors).  The recorder is fed float64 on the host; the solver gets
        f32, as in the reference."""
        x_np = np.asarray(torch.as_tensor(x_ic).cpu(), dtype=np.float64)
        u_np = (np.zeros((self.mpc.nu,), dtype=np.float32) if u_ic is None
                else torch.as_tensor(u_ic).cpu().numpy())
        x_ic, u_ic = self._f32(x_ic), self._f32(u_np)

        # LMPC bookkeeping: lazy lap load + per-step recording
        # (racing_mpc.cpp:240-246), on the host spline twin
        if self.ss_recorder is not None:
            if self.config.load and not self._ss_loaded:
                self.ss_recorder.load(self.config.load_path, self.track.total_length)
                self._ss_loaded = True
            self.ss_recorder.step(
                x_np, u_np, float(self.track.curvature_np(x_np[0])),
                self._time, self.track.total_length)
            self._time += self.dt

        if self.state is None:
            self.bootstrap(x_ic)
        # safe-set query at the (to-be-shifted) terminal point
        ss_x, ss_j = self._query_safe_set(self.state.last_X[-1])
        regs = self._query_regression(x_np, u_np)
        self.state, info = self._rti_step(
            x_ic, u_ic, self.state, ss_x, ss_j, self._f32(self.speed_limit),
            self._f32(self.speed_scale), regs)
        return info

    def _query_regression(self, x_np: np.ndarray, u_np: np.ndarray):
        """This cycle's error-dynamics regression around the current state and
        previous control: (dA, dB, dC) as f32 tensors on the controller's
        device, or None when the regression is off or no lap is stored."""
        if (self.regression is None or self.ss_manager is None
                or self.ss_manager.num_laps == 0):
            return None
        nx, nu = self.model.nx, self.model.nu
        groups = self.regression.groups
        # ONE multi-group query: the prediction sweep runs once per cycle
        res = self.ss_manager.query_regression(RegQuery(
            x=tuple(np.concatenate([x_np[list(in_x)], u_np[list(in_u)]])
                    for in_x, in_u, _ in groups),
            dist_max=self.regression.dist_max,
            reg_in_state_idxs=tuple(tuple(g[0]) for g in groups),
            reg_in_control_idxs=tuple(tuple(g[1]) for g in groups),
            reg_out_state_idxs=tuple((g[2],) for g in groups),
            A=np.zeros((nx, nx)), B=np.zeros((nx, nu)), C=np.zeros(nx),
            f=self.model.discrete_dynamics), device=self.device)
        return tuple(self._f32(a) for a in res)
