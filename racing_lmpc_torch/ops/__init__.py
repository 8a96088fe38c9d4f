"""Math core of the port: the counterpart of ``racing_lmpc_tpu.ops``."""

from racing_lmpc_torch.ops.math import (
    align_abscissa,
    align_yaw,
    global_to_frenet_rotation,
    lateral_sign,
    norm_2,
    wrap_to_pi,
)

__all__ = [
    "align_yaw",
    "align_abscissa",
    "lateral_sign",
    "global_to_frenet_rotation",
    "norm_2",
    "wrap_to_pi",
]
