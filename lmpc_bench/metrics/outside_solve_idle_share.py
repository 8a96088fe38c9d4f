"""The share of the traced session's wall in which the device idled while
the host was in no span of the port, between solves: each step's outputs
copied to the host and the next step's inputs.  The session's start before
the first solve (the profiler's start) is a span of its own and is not
counted here (``lmpc_bench/spans.py``)."""

from lmpc_bench import spans


def read(ctx):
    s = spans.split(ctx)
    return None if s is None else s.outside()
