"""Host time of one elementwise operation under the port's forward-mode
Jacobian, by the kind of its second operand.

    python tests/torch_port_forward_ad_cost.py

The models' Jacobians are ``torch.func.vmap`` of ``torch.func.jvp`` over
the basis tangents (``racing_lmpc_torch/models/base.py``).  Inside it, an
operation whose operands both carry a tangent runs through PyTorch's C++
forward formulas; one whose other operand carries none (a Python number, a
constant tensor) first builds a zero tangent whose shape PyTorch works out
through its Python meta kernels.  The script times five chained operations
of each kind on the double-track's linearization shape (one lane, 24
stages, 6 states, 9 tangents), and the same under a jvp nested in the
jvp (the Newton slope of the double-track's load transfer, if it were
taken by ``torch.func.jvp``).  Prints microseconds per operation; it
measures the host, so run it on the machine whose host time matters.
"""

from __future__ import annotations

import time

import torch


def per_op_us(op, nested: bool, reps: int = 20) -> float:
    x = torch.rand(1, 24, 6)
    eye = torch.eye(6)

    def five(a):
        return op(op(op(op(op(a)))))

    def inner(z):
        g = z[..., 0]
        r, dr = torch.func.jvp(five, (g,), (torch.ones_like(g),))
        return r / dr

    fn = inner if nested else five

    def column(t):
        return torch.func.jvp(fn, (x,), (t.expand_as(x),))

    torch.func.vmap(column)(eye)
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.func.vmap(column)(eye)
    return (time.perf_counter() - t0) / reps / 5 * 1e6


def main() -> None:
    torch.set_num_threads(1)
    c = torch.rand(1)
    ops = {"a * a (both carry tangents)": lambda a: a * a,
           "a * 2.0 (Python number)": lambda a: a * 2.0,
           "a * c (constant tensor)": lambda a: a * c,
           "aten.mul.Scalar(a, 2.0)": lambda a: torch.ops.aten.mul.Scalar(a, 2.0),
           "sin(a) (one operand)": torch.sin}
    for nested in (False, True):
        print("jvp nested in the Jacobian's jvp" if nested else "the Jacobian's jvp")
        for name, op in ops.items():
            print(f"  {name:30s} {per_op_us(op, nested):8.1f} us an operation", flush=True)


if __name__ == "__main__":
    main()
