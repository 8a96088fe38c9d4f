"""Host-device synchronizations a step, by the port's own counter
(``racing_lmpc_torch.spans.host_syncs``, counted at each site of the solve
path, each in a span named ``*_sync``), as each traced step's root span
records it: in the sweep the zoom ladder's ``any()`` before each of its 4
rounds, the row structure's 4 index uploads, and the scalar copied into
each of the 6 equality masks.  Layer: host dispatch (each one drains the
device's queue before the host issues more)."""

from lmpc_bench import spans


def read(ctx):
    s = spans.session(ctx)
    if s is None:
        return None
    return sum(x.syncs for x in s.spans if x.parent < 0) / ctx.steps
