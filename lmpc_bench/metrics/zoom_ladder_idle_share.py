"""The share of the traced session's wall in which the device idled while
the host was in the zoom ladder's own work: under ``ipm.zoom_sync`` (the
``any()`` before each round) and in ``ipm.zoom_round``'s own time, outside
its ``ipm.pass`` (the residual problem's set-up after the sync, and the
carry's selects; ``lmpc_bench/spans.py``)."""

from lmpc_bench import spans


def read(ctx):
    s = spans.split(ctx)
    return None if s is None else s.under("ipm.zoom_sync") + s.own("ipm.zoom_round")
