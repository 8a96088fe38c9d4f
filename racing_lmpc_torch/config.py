"""Configuration tree mirroring the reference's ROS parameter schema.

Port of ``racing_lmpc_tpu/config.py``: the same frozen dataclasses, the same
``*_from_params`` functions and the same parameter names, so the reference's
YAML param files (``/**: ros__parameters: ...``) are ingested directly.

PyYAML is not a dependency of the port, so the param files are read by
``load_ros_params`` below, a reader of its own for the subset of YAML the
shipped ROS2 param files use (see its docstring).  The data files are read
by path from the reference package's ``data/`` directory; nothing of that
package is imported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parent.parent / "racing_lmpc_tpu" / "data"
PARAM_DIR = DATA_DIR / "params"
TRACK_DIR = DATA_DIR / "tracks"
SS_DIR = DATA_DIR / "ss"


# ---------------------------------------------------------------------------
# Vehicle configuration (base_vehicle_model_config.hpp:30-154)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TyreConfig:
    radius: float = 0.0          # m
    width: float = 0.0           # m
    mass: float = 0.0            # kg
    moi: float = 0.0             # kg m^2
    pacejka_b: float = 0.0       # magic formula B
    pacejka_c: float = 0.0       # magic formula C
    pacejka_e: float = 0.0       # magic formula E
    pacejka_fz0: float = 1.0     # nominal normal load (N)
    pacejka_eps: float = 0.0     # load-sensitivity epsilon


@dataclass(frozen=True)
class BrakeConfig:
    max_brake: float = 0.0               # kPa
    brake_pad_out_r: float = 0.0         # m
    brake_pad_in_r: float = 0.0          # m
    brake_pad_friction_coeff: float = 0.0
    piston_area: float = 0.0             # m^2 (sum over pistons)
    bias: float = 0.5                    # fraction of total brake force


@dataclass(frozen=True)
class SteerConfig:
    max_steer_rate: float = 0.0   # rad/s at the wheel
    max_steer: float = 0.0        # rad, positive left
    turn_left_bias: float = 0.0   # rad


@dataclass(frozen=True)
class ChassisConfig:
    total_mass: float = 0.0    # kg
    sprung_mass: float = 0.0   # kg
    unsprung_mass: float = 0.0  # kg
    cg_ratio: float = 0.5      # weight fraction on front axle
    cg_height: float = 0.0     # m
    wheel_base: float = 1.0    # m
    tw_f: float = 0.0          # m
    tw_r: float = 0.0          # m
    moi: float = 1.0           # yaw inertia kg m^2
    b: float = 0.0             # vehicle width m
    fr: float = 0.0            # rolling resistance coefficient


@dataclass(frozen=True)
class AeroConfig:
    air_density: float = 1.2
    drag_coeff: float = 0.0
    frontal_area: float = 0.0
    cl_f: float = 0.0
    cl_r: float = 0.0


@dataclass(frozen=True)
class PowerTrainConfig:
    # torque (N m) lookup grid over rpm x throttle(0-100)
    rpm: tuple = ()
    throttle: tuple = ()
    torque: tuple = ()            # flattened row-major (len(rpm) * len(throttle))
    gear_ratio: tuple = ()
    final_drive_ratio: float = 1.0
    kd: float = 0.0               # drive-force fraction at front axle
    mechanical_efficiency: float = 1.0

    def torque_table(self) -> np.ndarray:
        return np.asarray(self.torque, dtype=np.float64).reshape(
            len(self.rpm), len(self.throttle))


@dataclass(frozen=True)
class ModelingConfig:
    use_frenet: bool = True
    integrator_type: str = "rk4"   # "rk4" | "euler"
    sample_throttle: float = 50.0


@dataclass(frozen=True)
class BaseVehicleConfig:
    """Mirrors ``BaseVehicleModelConfig`` (base_vehicle_model_config.hpp:139-152)."""
    front_tyre: TyreConfig = field(default_factory=TyreConfig)
    rear_tyre: TyreConfig = field(default_factory=TyreConfig)
    front_brake: BrakeConfig = field(default_factory=BrakeConfig)
    rear_brake: BrakeConfig = field(default_factory=BrakeConfig)
    steer: SteerConfig = field(default_factory=SteerConfig)
    chassis: ChassisConfig = field(default_factory=ChassisConfig)
    aero: AeroConfig = field(default_factory=AeroConfig)
    powertrain: PowerTrainConfig = field(default_factory=PowerTrainConfig)
    modeling: ModelingConfig = field(default_factory=ModelingConfig)


@dataclass(frozen=True)
class SingleTrackConfig:
    """``single_track_planar.*`` params (single_track_planar_model.hpp:34-46).

    Also used by the kinematic bicycle model, whose loader reads the same
    parameter section (kinematic_bicycle_model/ros_param_loader.cpp).
    """
    fd_max: float = 0.0
    fb_max: float = 0.0
    td: float = 1.0
    tb: float = 1.0
    v_max: float = 0.0
    p_max: float = 0.0
    mu: float = 1.0
    simplify_lon_control: bool = False


# Kinematic bicycle shares the same parameter schema (see loader note above).
KinematicBicycleConfig = SingleTrackConfig


@dataclass(frozen=True)
class DoubleTrackConfig(SingleTrackConfig):
    """``double_track_planar.*`` params (+ front roll distribution kroll_f)."""
    kroll_f: float = 0.5


# ---------------------------------------------------------------------------
# MPC / LQR / EKF / simulator configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RacingMPCConfig:
    """Mirrors ``RacingMPCConfig`` (racing_mpc_config.hpp:37-82)."""
    max_cpu_time: float = 0.085
    max_iter: int = 200
    tol: float = 1e-3
    n: int = 40                      # horizon length N
    margin: float = 0.0              # extra track-boundary margin (m)
    average_track_width: float = 1.0
    verbose: bool = False
    jit: bool = True

    q_contour: float = 1.0
    q_heading: float = 1.0
    q_boundary: float = 0.0          # 0 => hard boundary constraint
    q_vel: float = 1.0
    q_vy: float = 0.0
    q_vyaw: float = 0.0
    r: tuple = ()                    # nu*nu control cost, row-major
    r_d: tuple = ()                  # nu*nu control-rate cost, row-major
    max_vel_ref_diff: float = 1.0

    x_max: tuple = ()
    x_min: tuple = ()
    u_max: tuple = ()
    u_min: tuple = ()

    step_mode: str = "continuous"    # "continuous" | "step"

    # Elastic state boxes (TPU-engine extension, no reference analogue but
    # the same pattern as the reference's soft track boundary,
    # racing_mpc.cpp:524-543): 0 => hard x_min/x_max rows (parity); > 0 =>
    # one shared nonnegative slack relaxes every state box with quadratic
    # cost q_state_slack * slack^2.  Cures the transient LP-infeasibilities
    # of aggressive low-rate configs (Putnam-short LMPC at 10 Hz), where a
    # shifted warm start can make the one-step-reachable set miss a box.
    q_state_slack: float = 0.0

    # LMPC
    learning: bool = False
    convex_hull_slack: tuple = ()    # nx quadratic slack weights; all-0 => hard
    num_ss_pts: int = 0
    num_ss_pts_per_lap: int = 0
    max_lap_stored: int = 0

    # actuation-delay compensation: the applied command is u[delay_step]
    # of the solved plan (racing_mpc_node.hpp:61, pick at
    # racing_mpc_node.cpp:386-402; every shipped launch sets
    # racing_mpc_node.delay_step).  -1 = auto: 0 in step mode, 1 in
    # continuous mode (one control period of actuation latency).
    delay_step: int = -1

    # recording / lap checkpointing
    record: bool = False
    path_prefix: str = ""
    load: bool = False
    load_path: tuple = ()

    # TPU-solver knobs (no reference analogue)
    qp_method: str = "ipm"      # "ipm" (interior point) | "admm" (OSQP-style)
    qp_ip_iters: int = 14       # IPM Newton iterations (fixed count; 14
                                # solves 100% of BARC LMPC scenario batches
                                # across seeds with the best-iterate
                                # safeguard + polish, 12 drops ~0.4%)
    qp_iters: int = 400         # ADMM iterations
    qp_rho: float = 0.1
    qp_sigma: float = 1e-6
    qp_alpha: float = 1.6
    qp_polish: bool = True
    # zoomed-refinement rounds after the IPM (ipm.py: trust-region zoom
    # ladder — optimization-level iterative refinement with compensated
    # residuals, carried-zoom escalation, and EARLY EXIT once the
    # compensated correction is at the noise floor).  3 rounds is the
    # production default AND the config the acceptance suite gates
    # (tests/test_reference_match.py replays tests/data/acc_instances
    # against the per-instance gates pinned in ACCURACY.json, grounded in
    # the measured scatter of the reference's own solver — OSQP defaults +
    # polish, racing_mpc.cpp:85-103 — on the same instances).  4 is the
    # recorded Pareto knee (PARETO.json, swept on the real chip): rounds
    # <= 2 and every cheaper knob (zoom_iters 10/8, ip_iters 12/10)
    # violate at least one pinned applied-steer gate; rounds = 3 matches
    # 4 on every applied-steer gate (worst 1.18e-3) and buys ~35% batched
    # throughput, but leaves a 2.6e-3 objective gap on the degenerate
    # barc_lmpc[28] instance vs the 1e-3 quality cap — the 4th round
    # (which the early-exit ladder only runs where needed) restores it.
    # Strict quality wins the default; PARETO.json records the trade.
    qp_zoom_rounds: int = 4
    qp_zoom_iters: int = 0      # 0 => same as qp_ip_iters
    # In-loop SQP re-linearization count.  The reference solves the FULL
    # nonlinear program to convergence every cycle (IPOPT, max_iter 200,
    # max_cpu_time 0.085 — racing_mpc.cpp:85-103), so its applied plan is
    # always dynamically consistent; 1 = pure RTI (one linearization around
    # the shifted previous plan), which is exact enough at short horizons
    # (BARC: 1 s) but accumulates linearization error over long fast
    # horizons (IAC Putnam: 6 s, 60 stages, 10-30 m/s) until the "solved"
    # plan deviates unphysically from its own linearization point.  > 1
    # re-linearizes around the nonlinear rollout of the solved controls and
    # re-solves (damped), restoring the reference's converged-NLP semantics
    # at a bounded per-cycle cost.  The loop stops early once the damped
    # control update falls below sqp_relin_tol (scaled units) — the SQP
    # convergence criterion — so steady-state cycles cost one solve and
    # only transients pay for re-linearization.
    sqp_relin_steps: int = 1
    sqp_relin_tol: float = 0.02

    def R(self, nu: int) -> np.ndarray:
        return np.asarray(self.r, dtype=np.float64).reshape(nu, nu)

    def R_d(self, nu: int) -> np.ndarray:
        return np.asarray(self.r_d, dtype=np.float64).reshape(nu, nu)


@dataclass(frozen=True)
class RacingLQRConfig:
    """Mirrors ``RacingLQRConfig`` (racing_lqr_config.hpp:22-31)."""
    n: int = 20
    dt: float = 0.01
    q: tuple = ()
    r: tuple = ()
    qf: tuple = ()

    def Q(self, nx: int) -> np.ndarray:
        return np.asarray(self.q, dtype=np.float64).reshape(nx, nx)

    def Rm(self, nu: int) -> np.ndarray:
        return np.asarray(self.r, dtype=np.float64).reshape(nu, nu)

    def Qf(self, nx: int) -> np.ndarray:
        return np.asarray(self.qf, dtype=np.float64).reshape(nx, nx)


@dataclass(frozen=True)
class EKFConfig:
    """Mirrors ``EKFStateEstimatorConfig`` (ekf_state_estimator_config.hpp:23-31)."""
    x0: tuple = ()
    p0: tuple = ()
    q: tuple = ()
    x_max: tuple = ()
    x_min: tuple = ()
    reset_on_timestamp_jump: bool = True


@dataclass(frozen=True)
class SimulatorConfig:
    """Mirrors ``RacingSimulatorConfig`` (racing_simulator_config.hpp:17-36)."""
    dt: float = 0.01
    repeat_state_dt: float = 5.0
    publish_tf: bool = True
    visualize_boundary: bool = True
    visualize_abscissa: bool = True
    visualize_vehicle: bool = True
    x0: tuple = ()
    step_mode: str = "continuous"

# ---------------------------------------------------------------------------
# YAML ingestion (ROS2 param file format)
# ---------------------------------------------------------------------------

_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows a blank, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str):
    """A plain or quoted YAML scalar.  Unlike YAML 1.1, exponent literals
    without a dot (``1e-3``) are numbers, as the reference's ``*_from_params`` functions read
    them (``racing_lmpc_tpu/config.py:315-328``)."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    low = tok.lower()
    if low in _BOOLS:
        return _BOOLS[low]
    if low in ("", "~", "null"):
        return None
    if low in (".inf", "+.inf"):
        return math.inf
    if low == "-.inf":
        return -math.inf
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _value(text: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"malformed flow list: {text!r}")
        items = [t.strip() for t in text[1:-1].split(",")]
        if items and items[-1] == "":
            items.pop()            # trailing comma
        return [_scalar(t) for t in items]
    return _scalar(text)


def _logical_lines(text: str) -> list[tuple[int, str]]:
    """(indent, content) per non-blank line; a flow list spanning lines is
    joined into the line that opens it."""
    lines: list[tuple[int, str]] = []
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending[1] += " " + line.strip()
            if pending[1].count("[") == pending[1].count("]"):
                lines.append((pending[0], pending[1]))
                pending = None
            continue
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"tab indentation: {raw!r}")
        entry = [len(line) - len(line.lstrip(" ")), line.strip()]
        if entry[1].count("[") > entry[1].count("]"):
            pending = entry
        else:
            lines.append((entry[0], entry[1]))
    if pending is not None:
        raise ValueError("unterminated flow list")
    return lines


def parse_ros_yaml(text: str) -> dict:
    """Parse the YAML subset of the shipped ROS2 param files: nested block
    maps, block sequences of scalars, plain and quoted scalars, ``#``
    comments, flow lists (possibly spanning lines, trailing comma allowed)
    and ``.inf``/``-.inf``.  Anything else raises ``ValueError``."""
    lines = _logical_lines(text)
    root: dict = {}
    stack: list[tuple[int, dict | list]] = [(-1, root)]
    for i, (indent, content) in enumerate(lines):
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if content == "-" or content.startswith("- "):
            if not isinstance(parent, list):
                raise ValueError(f"sequence item outside a sequence: {content!r}")
            parent.append(_value(content[1:]))
            continue
        key, sep, rest = content.partition(":")
        if not sep or not isinstance(parent, dict):
            raise ValueError(f"unsupported YAML line: {content!r}")
        key = key.strip().strip("\"'")
        if rest.strip():
            parent[key] = _value(rest)
            continue
        nxt = lines[i + 1] if i + 1 < len(lines) else None
        if nxt is None or nxt[0] <= indent:
            parent[key] = None
            continue
        child: dict | list = [] if nxt[1].startswith("-") else {}
        parent[key] = child
        stack.append((indent, child))
    return root


def load_ros_params(*paths: str | Path) -> dict:
    """Read ROS2 param YAML file(s) and return the merged ``ros__parameters`` tree.

    Handles the ``/**: ros__parameters: {...}`` wrapper used by every
    reference param file; later files override earlier ones per-section.
    """
    merged: dict = {}
    for path in paths:
        doc = parse_ros_yaml(Path(path).read_text())
        for _node_key, node_val in doc.items():
            params = node_val.get("ros__parameters", node_val)
            for k, v in params.items():
                if isinstance(v, dict) and isinstance(merged.get(k), dict):
                    merged[k].update(v)
                else:
                    merged[k] = v
    return merged


def _sub(params: dict, key: str) -> dict:
    return dict(params.get(key) or {})


def _build(cls, d: dict, **extra):
    fields = {f for f in cls.__dataclass_fields__}
    kwargs = {}
    for k, v in {**d, **extra}.items():
        if k in fields:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def vehicle_config_from_params(params: dict) -> BaseVehicleConfig:
    """Build a ``BaseVehicleConfig`` from a merged ROS param tree.

    Mirrors ``base_vehicle_model/src/ros_param_loader.cpp:30-177``.
    """
    return BaseVehicleConfig(
        front_tyre=_build(TyreConfig, _sub(params, "front_tyre")),
        rear_tyre=_build(TyreConfig, _sub(params, "rear_tyre")),
        front_brake=_build(BrakeConfig, _sub(params, "front_brake")),
        rear_brake=_build(BrakeConfig, _sub(params, "rear_brake")),
        steer=_build(SteerConfig, _sub(params, "steer")),
        chassis=_build(ChassisConfig, _sub(params, "chassis")),
        aero=_build(AeroConfig, _sub(params, "aero")),
        powertrain=_build(PowerTrainConfig, _sub(params, "powertrain")),
        modeling=_build(ModelingConfig, _sub(params, "modeling")),
    )


def single_track_config_from_params(params: dict, **overrides) -> SingleTrackConfig:
    return _build(SingleTrackConfig, {**_sub(params, "single_track_planar"), **overrides})


def double_track_config_from_params(params: dict, **overrides) -> DoubleTrackConfig:
    return _build(DoubleTrackConfig, {**_sub(params, "double_track_planar"), **overrides})


def mpc_config_from_params(params: dict, **overrides) -> RacingMPCConfig:
    return _build(RacingMPCConfig, {**_sub(params, "racing_mpc"), **overrides})


def lqr_config_from_params(params: dict, **overrides) -> RacingLQRConfig:
    return _build(RacingLQRConfig, {**_sub(params, "racing_lqr"), **overrides})


def ekf_config_from_params(params: dict, **overrides) -> EKFConfig:
    return _build(EKFConfig, {**_sub(params, "ekf_state_estimator"), **overrides})


def simulator_config_from_params(params: dict, **overrides) -> SimulatorConfig:
    return _build(SimulatorConfig, {**_sub(params, "racing_simulator"), **overrides})


# ---------------------------------------------------------------------------
# Convenience loaders for the shipped vehicle parameter sets
# ---------------------------------------------------------------------------

def barc_vehicle() -> tuple[BaseVehicleConfig, SingleTrackConfig]:
    p = load_ros_params(PARAM_DIR / "barc_base.param.yaml",
                        PARAM_DIR / "barc_single_track.param.yaml")
    return vehicle_config_from_params(p), single_track_config_from_params(p)


def iac_vehicle() -> tuple[BaseVehicleConfig, SingleTrackConfig]:
    p = load_ros_params(PARAM_DIR / "iac_car_base.param.yaml",
                        PARAM_DIR / "iac_car_single_track.param.yaml")
    return vehicle_config_from_params(p), single_track_config_from_params(p)


def hawaii_gokart_vehicle() -> tuple[BaseVehicleConfig, SingleTrackConfig]:
    p = load_ros_params(PARAM_DIR / "hawaii_gokart_base.param.yaml",
                        PARAM_DIR / "hawaii_gokart_single_track.param.yaml")
    return vehicle_config_from_params(p), single_track_config_from_params(p)


def sample_vehicle() -> tuple[BaseVehicleConfig, SingleTrackConfig]:
    p = load_ros_params(PARAM_DIR / "sample_vehicle_base.param.yaml",
                        PARAM_DIR / "sample_vehicle_single_track.param.yaml")
    return vehicle_config_from_params(p), single_track_config_from_params(p)


def barc_mpc_config(name: str = "barc_lmpc", **overrides) -> RacingMPCConfig:
    p = load_ros_params(PARAM_DIR / f"{name}.param.yaml")
    return mpc_config_from_params(p, **overrides)


__all__ = [
    "TyreConfig", "BrakeConfig", "SteerConfig", "ChassisConfig", "AeroConfig",
    "PowerTrainConfig", "ModelingConfig", "BaseVehicleConfig",
    "SingleTrackConfig", "KinematicBicycleConfig", "DoubleTrackConfig",
    "RacingMPCConfig", "RacingLQRConfig", "EKFConfig", "SimulatorConfig",
    "load_ros_params", "parse_ros_yaml", "vehicle_config_from_params",
    "single_track_config_from_params", "double_track_config_from_params",
    "mpc_config_from_params", "lqr_config_from_params",
    "ekf_config_from_params", "simulator_config_from_params",
    "barc_vehicle", "iac_vehicle", "hawaii_gokart_vehicle", "sample_vehicle",
    "barc_mpc_config", "replace",
    "DATA_DIR", "PARAM_DIR", "TRACK_DIR", "SS_DIR",
]
