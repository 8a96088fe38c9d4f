"""Directory of racelines, indexed by number prefix.

Port of ``racing_lmpc_tpu/track/trajectory_map.py`` (racing_trajectory_map.cpp:
29-60): every ``NN_name.txt`` of a directory, loaded into an int-indexed map
for live raceline switching.
"""

from __future__ import annotations

import re
from pathlib import Path

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.track.trajectory import RacingTrajectory

_NAME_RE = re.compile(r"^(\d+)_(.+)\.txt$")


class RacingTrajectoryMap:
    def __init__(self, directory: str | Path, device=None):
        device = resolve_device(device)
        self.trajectories: dict[int, RacingTrajectory] = {}
        self.names: dict[int, str] = {}
        directory = Path(directory)
        for f in sorted(directory.iterdir()):
            m = _NAME_RE.match(f.name)
            if not m:
                continue
            idx = int(m.group(1))
            self.trajectories[idx] = RacingTrajectory.from_file(f, device=device)
            self.names[idx] = m.group(2)
        if not self.trajectories:
            raise ValueError(f"no NN_name.txt trajectories found in {directory}")

    def get_trajectory(self, index: int) -> RacingTrajectory:
        return self.trajectories[index]

    def indices(self) -> list[int]:
        return sorted(self.trajectories)
