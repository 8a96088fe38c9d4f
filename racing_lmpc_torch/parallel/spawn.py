"""Start a process group on one machine: ``spawn(n, "module:function")``.

The reference runs a mesh of n devices inside one program (virtual devices
on the CPU); the port needs one process a rank.  ``spawn`` starts n Python
processes (``python -m racing_lmpc_torch.parallel.spawn``), each joining
the group through ``distributed.initialize`` at a free local TCP port —
NCCL with one GPU each on CUDA, gloo with ``device="cpu"`` — and calling
the named function with the given arguments; it returns each rank's result
in rank order, and raises with the ranks' output when one fails or the
group outlives ``timeout``.  Every process has ended when it returns.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n: int, target: str, *args, device: str = "cuda",
          timeout: float = 600.0) -> list:
    """Run ``target`` (``"package.module:function"``) as every rank of an
    ``n``-process group on ``device`` (``"cuda"`` or ``"cpu"``); returns the
    ranks' return values.  A CPU rank keeps the caller's intra-op thread
    count."""
    import torch
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="rlmpc_spawn_") as tmp:
        tmp = Path(tmp)
        (tmp / "args.pkl").write_bytes(pickle.dumps(args))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        procs, logs = [], []
        for rank in range(n):
            log = open(tmp / f"rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "racing_lmpc_torch.parallel.spawn", target,
                 str(port), str(n), str(rank), device, str(torch.get_num_threads()),
                 str(tmp)], stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        out = []
        for log in logs:
            log.seek(0)
            out.append(log.read())
            log.close()
        if failed:
            raise RuntimeError(
                f"{target}: ranks {failed} of {n} failed (exit "
                f"{[procs[r].returncode for r in failed]}):\n"
                + "\n".join(f"--- rank {r} ---\n{out[r][-6000:]}" for r in failed))
        return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(n)]


def _rank_main(target: str, port: str, n: str, rank: str, device: str,
               threads: str, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    from racing_lmpc_torch.parallel import distributed
    if device == "cpu":
        torch.set_num_threads(int(threads))
    distributed.initialize(f"127.0.0.1:{port}", int(n), int(rank), device)
    try:
        args = pickle.loads((Path(tmp) / "args.pkl").read_bytes())
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
