"""The port's single-track planar model of a configuration: its
``vehicle`` and ``single_track_planar`` sections through the port's own
parameter ingestion, as the port reads the upstream param files.

A model file here gives ``build(cfg, decode)``, the port's model object of
configuration ``cfg`` (``decode`` turns the file's "inf" strings into
floats), found by the configuration's ``model``.
"""

from __future__ import annotations


def build(cfg: dict, decode):
    from racing_lmpc_torch import config as pc
    from racing_lmpc_torch.models import SingleTrackPlanarModel
    params = {**decode(cfg["vehicle"]),
              "single_track_planar": decode(cfg["single_track_planar"])}
    return SingleTrackPlanarModel(pc.vehicle_config_from_params(params),
                                  pc.single_track_config_from_params(params))
