"""``chol_tri_inv`` calls a step, by the port's own counter
(``ops.linalg.chol_tri_inv.launches``): two a Newton system (the Hessian and
the equality rows' Schur block), so it counts the IPM passes the zoom ladder
ran (at most 150 a step: 14 iterations and the polish, 5 passes)."""


def read(ctx):
    if ctx.chol_calls is None:
        return None
    return ctx.chol_calls / ctx.steps
