"""In-process message types mirroring mpclab_msgs / lmpc_msgs.

A copy of the dataclasses of ``racing_lmpc_tpu/msgs.py`` that the
co-simulation exchanges (``VehicleStateMsg`` and its parts,
``VehicleActuationMsg``, ``MPCTelemetry``, ``TrajectoryCommand``): field
names follow the reference's .msg definitions
(``src/common/mpclab_msgs/msg/*.msg``, ``src/common/lmpc_msgs``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

@dataclass
class PositionMsg:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclass
class OrientationEulerMsg:
    phi: float = 0.0
    theta: float = 0.0
    psi: float = 0.0


@dataclass
class OrientationQuaternionMsg:
    qr: float = 1.0
    qi: float = 0.0
    qj: float = 0.0
    qk: float = 0.0


@dataclass
class BodyLinearVelocityMsg:
    v_long: float = 0.0
    v_tran: float = 0.0
    v_n: float = 0.0


@dataclass
class BodyAngularVelocityMsg:
    w_phi: float = 0.0
    w_theta: float = 0.0
    w_psi: float = 0.0


@dataclass
class BodyLinearAccelerationMsg:
    a_long: float = 0.0
    a_tran: float = 0.0
    a_n: float = 0.0


@dataclass
class BodyAngularAccelerationMsg:
    a_phi: float = 0.0
    a_theta: float = 0.0
    a_psi: float = 0.0


@dataclass
class ParametricPoseMsg:
    """Frenet pose: abscissa s, lateral offset x_tran, heading error e_psi."""
    s: float = 0.0
    x_tran: float = 0.0
    n: float = 0.0
    e_psi: float = 0.0


@dataclass
class ParametricVelocityMsg:
    ds: float = 0.0
    dx_tran: float = 0.0
    dn: float = 0.0
    de_psi: float = 0.0


@dataclass
class VehicleActuationMsg:
    """mpclab_msgs/VehicleActuationMsg: signed longitudinal command + steer."""
    t: float = 0.0
    u_a: float = 0.0
    u_steer: float = 0.0


@dataclass
class DriveStateMsg:
    gear: int = 1
    throttle: float = 0.0
    brake: float = 0.0
    engine_rpm: float = 0.0


@dataclass
class VehicleStateMsg:
    """mpclab_msgs/VehicleStateMsg (VehicleStateMsg.msg:1-22)."""
    t: float = 0.0
    x: PositionMsg = field(default_factory=PositionMsg)
    e: OrientationEulerMsg = field(default_factory=OrientationEulerMsg)
    q: OrientationQuaternionMsg = field(default_factory=OrientationQuaternionMsg)
    w: BodyAngularVelocityMsg = field(default_factory=BodyAngularVelocityMsg)
    aa: BodyAngularAccelerationMsg = field(default_factory=BodyAngularAccelerationMsg)
    v: BodyLinearVelocityMsg = field(default_factory=BodyLinearVelocityMsg)
    a: BodyLinearAccelerationMsg = field(default_factory=BodyLinearAccelerationMsg)
    p: ParametricPoseMsg = field(default_factory=ParametricPoseMsg)
    pt: ParametricVelocityMsg = field(default_factory=ParametricVelocityMsg)
    u: VehicleActuationMsg = field(default_factory=VehicleActuationMsg)
    hw: DriveStateMsg = field(default_factory=DriveStateMsg)
    lap_num: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class MPCTelemetry:
    """lmpc_msgs/MPCTelemetry (MPCTelemetry.msg:1-24)."""
    trajectory_index: int = 0
    solved: bool = False
    cost: float = 0.0
    cost_trajectory: float = 0.0
    state: list = field(default_factory=list)
    control: list = field(default_factory=list)
    solve_time: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class TrajectoryCommand:
    """lmpc_msgs/TrajectoryCommand: live raceline / speed-limit command."""
    trajectory_index: int = 0
    speed_limit: float = 0.0
    velocity_profile_scale: float = 1.0
