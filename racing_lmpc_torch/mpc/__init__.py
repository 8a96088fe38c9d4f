"""Optimal-control solvers of the port: batched condensed MPC with its IPM
and ADMM backends, and the Riccati LQR."""

from racing_lmpc_torch.mpc.qp import QPData, QPSolution, admm_solve, solve_qp

__all__ = ["QPData", "QPSolution", "solve_qp", "admm_solve"]
