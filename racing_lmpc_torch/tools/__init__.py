"""The repo's tools around the engine, on the port.

Each runs as ``python -m racing_lmpc_torch.tools.<name>``, on the card
unless ``--device cpu`` is given:

- ``ground_accuracy``: the accuracy-grounding pipeline (capture the
  acceptance QP instances, run the reference-class f64 OSQP scatter and the
  engine over them, derive the per-instance gates), counterpart of
  ``scripts/ground_accuracy.py``; its outputs go under
  ``build/ground_accuracy/``.
- ``pareto``: the accuracy/throughput trade of the solver knobs, both sides
  measured on one device, counterpart of ``scripts/pareto_bench.py``;
  writes ``PARETO_torch.json``.
- ``multihost_report``: the scale-out report, counterpart of
  ``scripts/multihost_report.py``; writes ``MULTIHOST_torch.json``.
- ``record_putnam_ss``: the Putnam seed-lap recorder, counterpart of
  ``scripts/record_putnam_ss.py``; writes ``build/ss/putnam_short/``.

``accuracy`` holds the one reading of the ``ACCURACY.json`` gates that these
tools and ``chip_smoke.py`` share.

The files the repo's JAX tools wrote (``PROTECTED``) are the reference's
records: no tool here writes them, and each raises when asked to
(``writable``).
"""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build"
# the JAX package and its tools, the records and data they wrote, and the
# port's byte-for-byte copy of that data
PROTECTED = tuple(ROOT / p for p in (
    "racing_lmpc_tpu", "scripts", "tests/data/acc_instances", "ACCURACY.json",
    "PARETO.json", "MULTIHOST.json", "racing_lmpc_torch/data"))


def writable(path) -> Path:
    """``path``, resolved, once it is known not to be one of ``PROTECTED``
    nor inside one; raises ``ValueError`` otherwise."""
    p = Path(path).resolve()
    for q in PROTECTED:
        if p == q or q in p.parents:
            raise ValueError(f"{p} is the reference's ({q.relative_to(ROOT)}); "
                             f"the port's tools do not write it")
    return p
