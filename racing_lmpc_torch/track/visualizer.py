"""Trajectory visualization data: centerline/boundary polylines, predicted
paths, safe-set markers, vehicle polygon.

Port of ``racing_lmpc_tpu/track/visualizer.py`` (parity target
``racing_trajectory/src/ros_trajectory_visualizer.cpp:27-142``, which
samples 1000 abscissa points and publishes PolygonStamped messages, and the
node's path/marker publishing, racing_mpc_node.cpp:405-472).  Without ROS,
the products are arrays / JSON-serializable dicts for any frontend.  The
reference evaluates the track on its device; here every product comes from
the track's host (float64 SciPy) twins, so a visualizer never touches the
card.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from racing_lmpc_torch.track.trajectory import RacingTrajectory

ABSCISSA_SAMPLES = 1000   # matches ros_trajectory_visualizer.cpp:64


class TrajectoryVisualizer:
    def __init__(self, track: RacingTrajectory,
                 num_samples: int = ABSCISSA_SAMPLES):
        self.track = track
        self.num_samples = num_samples

    def change_trajectory(self, track: RacingTrajectory):
        """Hot-swap the visualized raceline (visualizer :117-129)."""
        self.track = track

    def polylines(self) -> dict:
        """Centerline + both boundaries as (num_samples, 2) arrays."""
        s = np.linspace(0.0, self.track.total_length, self.num_samples,
                        endpoint=False)
        center = self.track._xy_cs(s)
        yaw = self.track.yaw_np(s)
        left_t = self.track.left_boundary_np(s)
        right_t = self.track.right_boundary_np(s)
        normal = np.stack([-np.sin(yaw), np.cos(yaw)], axis=-1)
        return {
            "abscissa": s,
            "center": center,
            "left": center + normal * left_t[:, None],
            "right": center + normal * right_t[:, None],
        }

    def prediction_path(self, X_frenet: np.ndarray) -> np.ndarray:
        """Frenet-state horizon -> global (x, y, yaw) polyline
        (the node's mpc_vis_msg, racing_mpc_node.cpp:405-420)."""
        return self.track.frenet_to_global_np(np.asarray(X_frenet)[:, :3])

    def safe_set_markers(self, ss_x: np.ndarray) -> np.ndarray:
        """Safe-set states -> global marker positions (ss_visualization)."""
        return self.prediction_path(np.asarray(ss_x))

    @staticmethod
    def vehicle_polygon(pose_global: np.ndarray, length: float,
                        width: float) -> np.ndarray:
        """Vehicle footprint polygon (racing_simulator_node.cpp:286-331)."""
        x, y, yaw = pose_global
        c, s = np.cos(yaw), np.sin(yaw)
        corners = np.array([[length / 2, width / 2], [length / 2, -width / 2],
                            [-length / 2, -width / 2], [-length / 2, width / 2]])
        R = np.array([[c, -s], [s, c]])
        return corners @ R.T + np.array([x, y])

    def export_json(self, path: str | Path):
        data = {k: v.tolist() for k, v in self.polylines().items()}
        Path(path).write_text(json.dumps(data))

    def plot_run(self, states_global: np.ndarray, path: str | Path,
                 speeds: np.ndarray | None = None, title: str = ""):
        """Render the track (centerline + boundaries) and a driven
        trajectory to a PNG — the offline stand-in for the reference's
        Foxglove dashboard (lmpc.foxglove.json).

        ``states_global``: (T, >=2) global x/y positions; ``speeds``
        optionally colors the trajectory by velocity.  Needs matplotlib,
        imported here only.
        """
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        lines = self.polylines()
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.plot(*lines["center"].T, color="0.75", lw=0.8, ls="--",
                label="centerline")
        ax.plot(*lines["left"].T, color="0.3", lw=1.2)
        ax.plot(*lines["right"].T, color="0.3", lw=1.2)
        xy = np.asarray(states_global)[:, :2]
        if speeds is not None:
            sc = ax.scatter(xy[:, 0], xy[:, 1], c=np.asarray(speeds), s=4,
                            cmap="viridis")
            fig.colorbar(sc, ax=ax, label="speed [m/s]", shrink=0.8)
        else:
            ax.plot(xy[:, 0], xy[:, 1], color="C0", lw=1.5, label="driven")
        ax.set_aspect("equal")
        ax.set_title(title)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        fig.tight_layout()
        fig.savefig(path, dpi=130)
        plt.close(fig)
