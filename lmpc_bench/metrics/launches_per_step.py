"""Kernel launches a step: the device kernels (not copies or fills) that the
traced whole steps recorded, over the steps.  Layer: host dispatch (each
launch is one eager PyTorch dispatch or kernel call of the port)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches / ctx.steps
