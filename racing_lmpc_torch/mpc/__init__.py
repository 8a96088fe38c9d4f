"""Optimal-control solvers of the port: batched condensed MPC and its IPM."""
