"""racing_lmpc_torch/tools/multihost_report.py on the CPU: the report over 1
and 2 gloo ranks at a small shape (tests/test_torch_parallel.py's N=8,
K=16; 4 scenarios a rank, one repetition), and the committed
``MULTIHOST_torch.json``.

Tolerances: the live two-process run's sharded solved fraction and best
objective equal the unsharded batch's exactly (the same lanes, solved the
same way on each rank), its gathered controls within 1e-5 of them, both
ranks gathering the same solve; the decomposition's derived numbers as the
reference tool defines them from its four times.  The tool refuses to
write ``MULTIHOST.json``.
"""

import json

import pytest

import tests._torch_twin  # noqa: F401  (one torch thread per test worker)
from racing_lmpc_torch.tools import ROOT
from racing_lmpc_torch.tools import multihost_report


@pytest.fixture(scope="module")
def report():
    return multihost_report.report("cpu", cpu_ranks=(1, 2), batch_per_device=4, reps=1,
                                   shape=(8, 16), timeout=600)


def test_two_ranks_equal_unsharded(report):
    two = report["two_process_gloo"]
    assert two["processes"] == 2 and two["batch"] == 8
    assert two["solved_fraction"] == two["unsharded_solved_fraction"]
    assert two["min_cost"] == two["unsharded_min_cost"]
    assert two["solved_equal_unsharded"] and two["ranks_agree"]
    assert two["U_max_abs_diff_vs_unsharded"] <= 1e-5
    assert two["t_local_ms"] > 0 and two["t_global_ms"] > 0


def test_weak_scaling_and_decomposition(report):
    weak = report["weak_scaling_gloo_cpu"]
    assert [w["devices"] for w in weak] == [1, 2] and [w["batch"] for w in weak] == [4, 8]
    assert weak[0]["weak_scaling_efficiency"] == 1.0
    d = report["scaling_decomposition"]
    assert d["ranks"] == 2 and d["batch_per_device"] == 4
    t1, tb, tc, tcoll = (d[k] for k in ("t_1rank_smallbatch_ms", "t_1rank_fullbatch_ms",
                                        "t_2rank_compute_only_ms",
                                        "t_2rank_with_collectives_ms"))
    assert d["naive_weak_scaling_eff_2rank"] == pytest.approx(t1 / tc)
    assert d["core_contention_ceiling_2rank"] == pytest.approx((2 * 4 / tb) / (2 * 4 / t1))
    assert d["partition_efficiency_equal_work"] == pytest.approx(tb / tc)
    assert d["collective_fraction"] == pytest.approx(max(0.0, (tcoll - tc) / tcoll))
    # a 2-D (host=2, batch=2) mesh needs 4 ranks; NCCL needs the card
    assert "mesh_2d_host_batch" not in report and "nccl_world_size_1" not in report
    assert "caveat" in report and report["cpu_threads_per_rank"] == 1


def test_refuses_reference_record():
    with pytest.raises(ValueError, match="reference"):
        multihost_report.main(["--out", str(ROOT / "MULTIHOST.json"), "--device", "cpu"])


def test_committed_record():
    """MULTIHOST_torch.json, written on the card by the tool: every part,
    each gloo world size, the mesh held to its gathered flags, and the
    NCCL rank on the H100."""
    doc = json.loads((ROOT / "MULTIHOST_torch.json").read_text())
    assert "H100" in doc["nccl_world_size_1"]["device"] and doc["caveat"]
    assert doc["nccl_world_size_1"]["backend"] == "nccl"
    assert [w["devices"] for w in doc["weak_scaling_gloo_cpu"]] == [1, 2, 4]
    assert doc["scaling_decomposition"]["ranks"] == 4
    m = doc["mesh_2d_host_batch"]
    assert m["solved_fraction_psum"] == m["gathered_solved_fraction"]
    assert m["min_cost_pmin"] == m["gathered_min_cost"]
    two = doc["two_process_gloo"]
    assert two["solved_equal_unsharded"] and two["min_cost"] == two["unsharded_min_cost"]
