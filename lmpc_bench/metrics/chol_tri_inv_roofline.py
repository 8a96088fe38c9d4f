"""``chol_tri_inv``'s share of its roofline, in %: the least time its calls
could take (``roofline.chol_tri_inv_bound_s`` of each call's shape) over the
device time of its kernels.  A kernel whose name says ``1x1`` factors the
1 x 1 Schur blocks of the equality rows; the others the n x n Hessians."""

from lmpc_bench import roofline


def read(ctx):
    if ctx.trace is None or ctx.card is None:
        return None
    bound = spent = 0.0
    for name, (count, sec) in ctx.trace.rows.items():
        if "chol_tri_inv" not in name:
            continue
        n = 1 if "1x1" in name else ctx.layout["n"]
        bound += count * roofline.chol_tri_inv_bound_s(ctx.batch, n, ctx.card)
        spent += sec
    return 100.0 * bound / spent if spent else None
