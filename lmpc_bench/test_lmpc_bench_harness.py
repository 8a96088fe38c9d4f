"""CPU tests of the benchmark's harness: every cell at a tiny batch on the
port's CPU path, the result line, the manifest's names and units, the
roofline's counts, the harness finding added files by name, and what the
benchmark's processes import.

    python -m pytest lmpc_bench -q          (the card's cases: -m cuda)
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from lmpc_bench import roofline, run

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def run_cell(cell: str, trace: int, batch: int = 2, seed: int = 3000000001) -> tuple[int, dict, str]:
    """One run of ``cell`` on the CPU: (exit code, result line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.01",
                       "--trace", str(trace)], device="cpu", batch=batch)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else {}, err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_cpu(cell, trace):
    rc, res, err = run_cell(cell, trace)
    assert rc == 0, err
    assert set(res) == RESULT_KEYS | ({"breakdown"} if "breakdown" in res else set())
    assert list(res)[-1] == "check"
    assert res["correct"] is True, err
    assert res["attempted"] >= 2 and 0 <= res["failed"] <= res["attempted"]
    names = {m["name"] for m in (MANIFEST["per_layer"] if trace else MANIFEST["end_to_end"])}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    assert res["device"]["platform"] == "cpu"
    # the compared numbers close standard error, each with its limit
    tail = err.strip().splitlines()[-len(res["check"]):] if res["check"] else []
    assert [t.split(":")[0] for t in tail] == [f"check {k}" for k in res["check"]]


def test_no_run_loads_jax_and_the_reference_loads_no_port():
    """A process that runs every cell on the CPU loads no module of JAX or
    of the JAX package (top-level names compared whole); one that loads the
    reference loads nothing of the port."""
    code = (
        "import sys, contextlib, io\n"
        "from lmpc_bench import run\n"
        f"for cell in {CELLS!r}:\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        assert run.main(['--workload', cell, '--seed', '5', '--seconds', '0.01'],\n"
        "                        device='cpu', batch=1) == 0\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'racing_lmpc_tpu'}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys\n"
            "import lmpc_bench.reference.qp as q\n"
            "import lmpc_bench.scenarios, lmpc_bench.roofline\n"
            "import json\n"
            "q.load_model(json.load(open('lmpc_bench/configs/barc_lmpc.json')))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'racing_lmpc_torch'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    for path in (ROOT / "lmpc_bench").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|racing_lmpc_tpu)\b",
                             text, re.M), path
        assert not re.search(r"^\s*(import|from)\s+(chip_smoke|bench|racing_lmpc_torch\.bench)\b",
                             text, re.M), path


def test_manifest_names_units_and_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["lmpc_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lmpc_bench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert (ROOT / "lmpc_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "lmpc_bench" / "limits" / f"{w['name']}.json").is_file()
        names += [w["name"], w["traffic"]]
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
        assert (ROOT / "lmpc_bench" / "metrics" / f"{m['name']}.py").is_file()
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_roofline_counts_by_hand():
    # (2, 5, 5): each lower triangle 15 floats read, each dense 25 written
    assert roofline.chol_tri_inv_bytes(2, 5) == 4 * 2 * (15 + 25)
    assert roofline.chol_tri_inv_flops(2, 5) == pytest.approx(2 * 2 / 3 * 125)
    # (1, 175, 175): 15,400 + 30,625 floats; 2/3 175^3 flops
    assert roofline.chol_tri_inv_bytes(1, 175) == 4 * (15400 + 30625)
    assert roofline.chol_tri_inv_flops(1, 175) == pytest.approx(3572916.6667, rel=1e-9)
    card = roofline.peaks("NVIDIA H100 80GB HBM3")
    # bytes bound both: 184,100 B at 3.35 TB/s
    assert roofline.chol_tri_inv_bound_s(1, 175, card) == pytest.approx(184100 / 3.35e12)
    assert roofline.peaks("a card of another kind") is None
    # the whole name: another part of the same chip has other peaks
    assert roofline.peaks("NVIDIA H100 PCIe") is None


def test_added_files_are_found_by_name(tmp_path):
    """A configuration that brings a model of its own (the port's builder
    and the reference's model), a traffic mix, a limits file and a
    per-layer metric dropped into a copy of the benchmark are found with no
    file edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lmpc_bench", tmp_path / "lmpc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "lmpc_bench"
    # each side's copy of the model notes in a file that it was used
    used = tmp_path / "used.txt"
    for part, fn in (("system_models", "build"), ("reference/models", "from_config")):
        text = (here / part / "single_track.py").read_text()
        (here / part / "single_track_copy.py").write_text(
            f"{text}\n_{fn} = {fn}\n\n\ndef {fn}(*args):\n"
            f"    open({str(used)!r}, 'a').write('{part}\\n')\n    return _{fn}(*args)\n")
    cfg = json.loads((here / "configs" / "barc_lmpc.json").read_text())
    cfg["name"], cfg["model"] = "barc_lmpc_copy", "single_track_copy"
    (here / "configs" / "barc_lmpc_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "sweep_b4096.json").read_text())
    (here / "traffic" / "sweep_b3.json").write_text(json.dumps({**mix, "batch": 3}))
    (here / "limits" / "barc_lmpc_copy.sweep_b3.json").write_text(
        json.dumps({"numbers": {"unsolved_share": {"limit": 0.5}}}))
    (here / "metrics" / "lanes_per_step.py").write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({**man["configs"][0], "name": "barc_lmpc_copy",
                           "file": "lmpc_bench/configs/barc_lmpc_copy.json"})
    man["workloads"].append({"name": "barc_lmpc_copy.sweep_b3", "config": "barc_lmpc_copy",
                             "traffic": "sweep_b3", "chips": 1, "why": "a copy"})
    man["per_layer"].append({"name": "lanes_per_step", "unit": "lanes", "better": "higher",
                             "source": "program_counter", "layer": "traffic",
                             "moves": "solves_per_s", "workloads": ["barc_lmpc_copy.sweep_b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = run.load_cell("barc_lmpc_copy.sweep_b3", tmp_path)
    assert cell["config"]["name"] == "barc_lmpc_copy"
    assert cell["mix"]["batch"] == 3
    assert cell["limits"] == {"unsolved_share": {"limit": 0.5}}
    assert [m["name"] for m in cell["per_layer"]] == ["lanes_per_step"]
    assert run.reader(cell["here"], "lanes_per_step")(type("C", (), {"batch": 3})) == 3.0
    # a run from the copy, as from a checkout (the port from this tree)
    code = ("import sys\n"
            "from lmpc_bench import run\n"
            f"assert run.__file__.startswith({str(tmp_path)!r}), run.__file__\n"
            "sys.exit(run.main(['--workload', 'barc_lmpc_copy.sweep_b3', '--seed', '9',\n"
            "                   '--seconds', '0.01', '--trace', '1'], device='cpu', batch=1))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
    # both sides of the new model came from the added files
    assert set(used.read_text().split()) == {"system_models", "reference/models"}


def test_a_cell_without_limits_is_not_correct(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lmpc_bench", tmp_path / "lmpc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "barc_lmpc.unlimited", "config": "barc_lmpc",
                             "traffic": "sweep_b4096", "chips": 1, "why": "no limits file"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main(["--workload", "barc_lmpc.unlimited", "--seed", "3", "--seconds",
                         "0.01"], device="cpu", batch=1, root=tmp_path) == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1])["correct"] is False


def test_no_card_no_result(capsys):
    """Without a card the benchmark prints no result and exits non-zero."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
