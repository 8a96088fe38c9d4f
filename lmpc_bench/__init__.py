"""The benchmark of the PyTorch + CUDA port (``racing_lmpc_torch``) on an
NVIDIA H100: batched learning-MPC solves of the upstream project's shipped
LMPC configurations.  ``python3 -m lmpc_bench --help``; see ``run.py``."""
