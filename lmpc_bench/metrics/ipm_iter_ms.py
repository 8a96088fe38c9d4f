"""Wall time of one Newton iteration of the IPM, on the host's clock: the
mean duration of the port's ``ipm.iter`` spans over the traced steps, in ms
(70 a step in the sweep: 14 iterations in each of 5 passes).  The host
issues an iteration's ~500 launches faster than the card runs them and
waits in the full launch queue, so the span lasts as long as the card takes
for the iteration: a faster Newton system (the KKT products,
``chol_tri_inv``, the elementwise passes) moves it, a cheaper dispatch
alone does not.  Layer: IPM and zoom ladder."""

from lmpc_bench import spans


def read(ctx):
    s = spans.session(ctx)
    iters = [x.t1_ns - x.t0_ns for x in s.spans if x.name == "ipm.iter"] if s else []
    return sum(iters) / len(iters) / 1e6 if iters else None
