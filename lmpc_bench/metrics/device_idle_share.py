"""The share of the traced steps' wall time (host clock, each step ended by
its outputs on the host) in which no operation ran on the device: one minus
the union of the device's busy intervals over the window."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.window_s
