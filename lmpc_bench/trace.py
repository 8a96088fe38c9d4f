"""The traced run's reading of the device: a profiler session of CUDA
activity over whole steps, read from the profiler's raw events.

The raw events are read directly (the port's ``chip_smoke.device_rows``
arithmetic): building one event object per launch took up to ~70 s on a
path of 2.5e5 launches.  The profiler on the card has been seen to drop the
kernel records of whole sessions, so a session counts only when the
``chol_tri_inv`` kernels it recorded match the port's own count of the calls
that launched it (``whole``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

MEMOPS = ("Memcpy", "Memset")


@dataclass
class DeviceTrace:
    rows: dict = field(default_factory=dict)     # name -> [count, seconds]
    intervals: list = field(default_factory=list)  # (start_ns, end_ns, name)

    @property
    def launches(self) -> int:
        return sum(c for k, (c, _) in self.rows.items() if not k.startswith(MEMOPS))

    def count(self, part: str) -> int:
        return sum(c for k, (c, _) in self.rows.items() if part in k)

    def merged(self):
        """The device's busy intervals (union over streams), in order."""
        out = []
        for s, e, name in sorted(self.intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e, name])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e, _ in self.merged()) / 1e9

    def top_ops(self, k: int = 10) -> list:
        return [[name, sec] for name, (_, sec) in
                sorted(self.rows.items(), key=lambda r: -r[1][1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time between busy intervals, summed by the device operation
        whose launch ended the gap (what the host was preparing)."""
        by: dict = {}
        m = self.merged()
        for (_, e0, _), (s1, _, name) in zip(m, m[1:]):
            key = f"before {name}"
            by[key] = by.get(key, 0.0) + (s1 - e0) / 1e9
        return [[n, s] for n, s in sorted(by.items(), key=lambda r: -r[1])[:k]]


def read(prof) -> DeviceTrace:
    """The device operations of a finished ``torch.profiler.profile``."""
    import torch
    t = DeviceTrace()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_hidden_event():
            continue
        name = e.name()
        row = t.rows.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e9
        t.intervals.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    return t
