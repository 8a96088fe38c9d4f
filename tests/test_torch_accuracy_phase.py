"""chip_smoke.py's accuracy phase (``accuracy_phase``) on the CPU for two
pinned instances: the port's solve of 9 copies at the instance's
ACCURACY.json gates in the reference QP built by the port's own f64 oracle,
that build's drift from the export, the oracle's certified solve, and (on
the deviated instance) the port's OSQP reproducing the reference-class
wander; the card runs the same phase on all 11 instances."""

import pytest
import torch

import chip_smoke
from tests import torch_port_fixture
from tests._torch_twin import acc_instances


@pytest.mark.parametrize("tag", ["barc_tracking_mpc_dev[6]", "putnam_short_tracking_mpc[20]"])
def test_accuracy_phase_on_cpu(tag):
    res = chip_smoke.accuracy_phase(torch.device("cpu"), tags=[tag])
    assert res["failed"] == [], res["lines"]
    assert list(res["oracle_ms"]) == [tag]
    assert any(line.startswith(f"accuracy {tag}: 9/9 solved") for line in res["lines"])
    if "_dev" in tag:
        assert res["osqp"]["iters"] == [525, 525]
        assert res["osqp"]["scatter"] > 1e-2
    else:
        assert res["osqp"] == {}


def test_accuracy_phase_reads_every_instance_and_size():
    """chip_smoke.py reads the 11 pinned instances with their gates; the
    condensed QP sizes it gives the kernel phase are each scenario's."""
    insts = chip_smoke.acc_instances()
    assert [rec["tag"] for rec, _, _ in insts] == [
        r["tag"] for s in ("barc_tracking_mpc", "barc_lmpc", "putnam_short_tracking_mpc")
        for r, _ in acc_instances(s)]
    assert all({"applied_steer_gate", "obj_gap_gate"} <= set(g) for _, _, g in insts)
    assert chip_smoke.acc_qp_sizes() == {"barc_tracking_mpc": 39, "barc_lmpc": 135,
                                         "putnam_short_tracking_mpc": 59}
    assert chip_smoke.ENTRY_CASE == torch_port_fixture.ENTRY_CASE
