"""The share of the traced session's wall in which the device idled while
the host was in the QP build: under the port's ``mpc.build_qp`` span and its
children (``mpc.condense``, ``mpc.linearize``; ``lmpc_bench/spans.py``)."""

from lmpc_bench import spans


def read(ctx):
    s = spans.split(ctx)
    return None if s is None else s.under("mpc.build_qp")
