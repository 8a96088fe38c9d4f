"""racing_lmpc_torch/tools/record_putnam_ss.py on the CPU against stored runs
of scripts/record_putnam_ss.py's loop (``tools_putnam_ss.npz``, written by
``tests/torch_port_fixture.py``: the reference's tracking controller at the
LMPC launch state and rate, scale 0.55, 10 cycles; the run itself and 4
re-runs with every state the controller receives moved by one f32
rounding).

The first cycle bootstraps the controller from the launch state, where one
f32 rounding of the state moves the reference's own first control far
beyond rounding (its moved runs show it): so the rows are held to the
reference's own spread (``chip_smoke.ss_held``, as the card holds
them): each row part's largest difference from the reference's run over the
10 cycles (state and previous control relative to max(1, |reference|),
curvature and time absolute) within the worst such difference between two
of its runs, floored at 1e-4, 1e-4, 1e-6 and 1e-9; no more fallbacks than
its worst run.  The time column is exact.  The tool refuses to write into
the shipped laps.
"""

import pytest

import chip_smoke
import tests._torch_twin  # noqa: F401  (one torch thread per test worker)
from racing_lmpc_torch.config import SS_DIR
from racing_lmpc_torch.tools import BUILD_DIR
from racing_lmpc_torch.tools import record_putnam_ss
from tests import torch_port_fixture as tf


def test_first_rows_match_reference(tmp_path):
    fx = chip_smoke.load_fixture(tf.TOOLS_SS_CASE)
    res = record_putnam_ss.record(tmp_path / "ss", max_steps=tf.TOOLS_SS_STEPS, device="cpu",
                                  log_every=0)
    assert res["steps"] == tf.TOOLS_SS_STEPS and res["laps"] == 0
    assert {k: v.shape for k, v in res["rows"].items()} == {
        k: fx[k].shape[1:] for k in ("x", "u", "k", "t")}
    reading, limits, held = chip_smoke.ss_held(
        res["rows"], round(res["fallback"] * res["steps"]), fx)
    assert held, (reading, limits)
    assert reading["t"] == 0.0


def test_default_output_and_refusal(tmp_path):
    assert record_putnam_ss.OUT_DIR == BUILD_DIR / "ss" / "putnam_short"
    for out in (SS_DIR / "putnam_short", SS_DIR):
        with pytest.raises(ValueError, match="reference"):
            record_putnam_ss.record(out, max_steps=1, device="cpu")
        with pytest.raises(ValueError, match="reference"):
            record_putnam_ss.main(["--out", str(out), "--max-steps", "1", "--device", "cpu"])
