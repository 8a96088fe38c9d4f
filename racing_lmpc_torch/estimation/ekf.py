"""Extended Kalman filter on the vehicle model with a pluggable observation
registry.

Port of ``racing_lmpc_tpu/estimation/ekf.py`` (parity target
``ekf_state_estimator/src/ekf_state_estimator.cpp``):

- observations registered by name before ``initialize()``; each
  ``h(x, z)`` gets a forward-mode Jacobian H and a slice of the block
  Kalman-gain matrix (register_observation, :72-99);
- ``update_observation``: RK4 prediction with F = dx+/dx at curvature 0
  (:43-49,137-151), the standard correction (innovation, S = HPH' + R,
  K = PH'S^-1), NaN/Inf input rejection falling back to pure prediction
  (:155-167), covariance sanitation (:238-264), state clipping to the
  config bounds (:199-202), a clock reset on a timestamp jump back
  (:133-135);
- the same exceptions (ekf_state_estimator.hpp:44-101).

Where the reference jits one step function per observation source, the port
runs plain functions on tensors on its device (CUDA unless the caller names
one).  Jacobians are forward mode as in ``models/base.py``: ``vmap`` of
``jvp`` over the basis tangents, the dynamics' on a batch of one (PyTorch
2.13 promotes the forward-mode tangents of 0-d intermediates to float64).  S^-1 is the
reference's ``inv_small``: the closed form for k <= 3 and a library inverse
above, as ``jnp.linalg.inv`` there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import EKFConfig
from racing_lmpc_torch.control.telemetry import LogLevel
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.ops.integrators import rk4
from racing_lmpc_torch.ops.linalg import inv_small


class EKFAlreadyInitializedException(RuntimeError):
    pass


class EKFUninitializedException(RuntimeError):
    pass


class NoObservationRegisteredException(RuntimeError):
    pass


class ObservationNameAlreadyExistsException(RuntimeError):
    pass


class ObservationNameNotFoundException(RuntimeError):
    pass


def _sanitize_cov(x: Tensor, P: Tensor):
    """State-covariance sanitation (check_cov, ekf_state_estimator.cpp:238-264):
    symmetrize, zero non-finite entries, floor the diagonal at 1e-9.
    Returns (x, P, flag), the flag set where P needed repair."""
    P_sym = 0.5 * (P + P.T)
    finite = torch.isfinite(P_sym)
    p_bad = (~finite).any() | (torch.diagonal(P_sym) < 0.0).any()
    P_fixed = torch.where(finite, P_sym, 0.0)
    P_fixed.diagonal().clamp_(min=1e-9)
    return x, P_fixed, p_bad


def _jacobian(h: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """d h / d x at one state ``x`` (n,) by forward mode: an observation
    function is written for one state, as the reference's are."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)

    def column(t):
        return torch.func.jvp(h, (x,), (t,))[1]
    return torch.movedim(torch.func.vmap(column)(eye), 0, -1).to(x.dtype)


def _inv(S: Tensor) -> Tensor:
    """The reference's ``inv_small`` (``pallas_linalg.py:394-420``): the
    closed form for k <= 3, a library inverse above."""
    return inv_small(S) if S.shape[-1] <= 3 else torch.linalg.inv(S)


class EKFStateEstimator:
    def __init__(self, config: EKFConfig, model: VehicleModel,
                 logger=None, debug: bool = False, device=None):
        """``logger`` is a telemetry.Logger sink for the WARN on sanitation
        and (with ``debug=True``) the matrix dumps the reference emits
        (ekf_state_estimator.cpp:138-210)."""
        self.device = resolve_device(device)
        self.config = config
        self.model = model
        self.logger = logger
        self.debug = debug
        nx = model.nx

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32,
                                   device=self.device)
        self.x = dev(config.x0)
        self.P = dev(np.reshape(config.p0, (nx, nx)))
        self.Q = dev(np.reshape(config.q, (nx, nx)))
        self.x_min = dev(config.x_min)
        self.x_max = dev(config.x_max)
        self.u = torch.zeros((model.nu,), device=self.device)
        self._hs: dict[str, Callable] = {}
        self._slices: dict[str, slice] = {}
        self._nz: dict[str, int] = {}
        self.K = torch.zeros((nx, 0), device=self.device)
        self.initialized = False
        self.nanosec = 0

    # ------------------------------------------------------------------
    def register_observation(self, name: str, nz: int, h: Callable):
        """Register ``h(x, z) -> z_pred`` before initialization
        (ekf_state_estimator.cpp:72-99).  ``h`` takes one state and one
        observation (no batch dimension), as the reference's do."""
        if self.initialized:
            raise EKFAlreadyInitializedException()
        if name in self._hs:
            raise ObservationNameAlreadyExistsException(name)
        self._hs[name] = h
        begin = self.K.shape[1]
        self._slices[name] = slice(begin, begin + nz)
        self._nz[name] = nz
        self.K = torch.cat([self.K, self.K.new_zeros((self.model.nx, nz))], dim=1)

    def initialize(self, timestamp_ns: int):
        if self.K.shape[1] == 0:
            raise NoObservationRegisteredException()
        self.initialized = True
        self.nanosec = int(timestamp_ns)

    # ------------------------------------------------------------------
    def _predict(self, x: Tensor, u: Tensor, P: Tensor, dt: Tensor):
        zero_k = x.new_zeros(())

        # F on a batch of one, through the model's forward-mode Jacobian
        x_p, F, _ = self.model._forward_jacobian(
            lambda xx, uu: rk4(self.model.dynamics, xx, uu, zero_k, dt), x[None], u[None])
        x_p, F = x_p[0], F[0]
        return x_p, F @ P @ F.T + self.Q

    def _step(self, h, x, u, P, dt, z, R):
        """One predict + correct (``ekf.py:116-146``); ``h`` None predicts
        only."""
        nx = self.model.nx
        x_p, P_p = self._predict(x, u, P, dt)
        if h is None:
            x_p, P_p, p_bad = _sanitize_cov(
                torch.minimum(torch.maximum(x_p, self.x_min), self.x_max), P_p)
            return x_p, P_p, x.new_zeros((nx, 0)), p_bad
        bad = ~(torch.isfinite(z).all() & torch.isfinite(R).all())
        # covariance sanitation (check_cov, :238-264)
        R = torch.clamp(R, min=0.0)
        R.diagonal().clamp_(min=1e-6)
        z_safe = torch.where(torch.isfinite(z), z, 0.0)
        H = _jacobian(lambda xv: h(xv, z_safe), x_p)
        y = z_safe - h(x_p, z_safe)
        S = H @ P_p @ H.T + R
        Kz = P_p @ H.T @ _inv(S)
        x_c = x_p + Kz @ y
        P_c = (torch.eye(nx, dtype=x.dtype, device=x.device) - Kz @ H) @ P_p
        # NaN/Inf input -> pure prediction (:155-167)
        x_new = torch.where(bad, x_p, x_c)
        P_new = torch.where(bad, P_p, P_c)
        Kz = torch.where(bad, torch.zeros_like(Kz), Kz)
        x_new, P_new, p_bad = _sanitize_cov(
            torch.minimum(torch.maximum(x_new, self.x_min), self.x_max), P_new)
        return x_new, P_new, Kz, p_bad | bad

    # ------------------------------------------------------------------
    def update_control(self, u):
        """Latest control input for the prediction step (:216-219)."""
        self.u = torch.as_tensor(u, dtype=torch.float32).to(self.device)

    def update_observation(self, name: str | None, timestamp_ns: int,
                           z=None, R=None) -> dict:
        """Predict + correct with the named observation; ``name=None`` is a
        pure-prediction update (:112-214)."""
        if not self.initialized:
            raise EKFUninitializedException()
        if name is not None and name not in self._hs:
            raise ObservationNameNotFoundException(name)
        dt_ns = int(timestamp_ns) - self.nanosec
        if dt_ns < 0:
            # timestamp jump back: reset the filter clock (:133-135)
            self.initialize(timestamp_ns)
            dt_ns = 0
        dt = torch.tensor(dt_ns * 1e-9, dtype=torch.float32, device=self.device)
        if name is None:
            x, P, Kz, p_bad = self._step(None, self.x, self.u, self.P, dt, None, None)
        else:
            def f32(a):
                return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)
            x, P, Kz, p_bad = self._step(self._hs[name], self.x, self.u, self.P, dt,
                                         f32(z), f32(R))
            self.K = self.K.clone()
            self.K[:, self._slices[name]] = Kz
        self.x, self.P = x, P
        self.nanosec = int(timestamp_ns)
        sanitized = bool(p_bad)
        if self.logger is not None:
            if sanitized:
                # the reference's WARN when check_cov repairs P or a NaN/Inf
                # observation was rejected (:155-167,238-264)
                self.logger.send_log(
                    LogLevel.WARN,
                    f"EKF sanitation engaged on update '{name}' "
                    f"(non-finite input or covariance repaired)")
            if self.debug:
                # deep-debug matrix dumps (:138-210)
                self.logger.send_log(
                    LogLevel.DEBUG,
                    f"EKF update '{name}': x={x.cpu().numpy()}\n"
                    f"P={P.cpu().numpy()}\nK={self.K.cpu().numpy()}\n"
                    f"Kz={Kz.cpu().numpy()}")
        return {"x": self.x, "P": self.P, "K": self.K, "Kz": Kz, "sanitized": sanitized}
