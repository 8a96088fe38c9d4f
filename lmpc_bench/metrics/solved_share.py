"""The share of the traced steps' lanes that the port reports ``solved``
(its scaled residuals under the configuration's tolerance)."""


def read(ctx):
    return float(ctx.solved.mean())
