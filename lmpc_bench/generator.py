"""The one traffic generator: it reads a mix file (``traffic/<name>.json``)
and hands the window its steps.

A mix gives ``batch`` (lanes a step) and ``pool`` (distinct batches drawn
from the seed at set-up, uploaded to the device and cycled through the
window: independent scenarios with no warm start, a scenario sweep).  Every
seed draws the same sizes; only the scenarios differ.
"""

from __future__ import annotations

import numpy as np
import torch

from lmpc_bench.scenarios import FIELDS, ScenarioMaker


class Traffic:
    def __init__(self, mix: dict, cfg: dict, seed: int, device, batch: int | None = None):
        self.batch = int(batch or mix["batch"])
        maker = ScenarioMaker(cfg)
        rng = np.random.default_rng(seed)
        self.pool = [maker.batch(rng, self.batch) for _ in range(int(mix["pool"]))]
        self.device_pool = [{k: torch.as_tensor(b[k], device=device) for k in FIELDS}
                            for b in self.pool]
        self.k = 0

    def next(self) -> tuple[dict, int]:
        """The next step's input (tensors on the device) and the pool batch
        it came from."""
        p = self.k % len(self.pool)
        self.k += 1
        return self.device_pool[p], p

    def lanes(self, pools: list[int], picks: list[tuple[int, int]]) -> dict:
        """The inputs of the (step, lane) pairs ``picks``, as numpy fields,
        where step s came from pool batch ``pools[s]``."""
        return {k: np.stack([self.pool[pools[s]][k][b] for s, b in picks]) for k in FIELDS}
