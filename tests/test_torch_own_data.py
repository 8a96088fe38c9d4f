"""The port reads its own data and nothing of the JAX package.

``racing_lmpc_torch/data/`` is the port's copy of ``racing_lmpc_tpu/data/``
(param files, tracks, safe-set laps, LQR tables), byte for byte.  No module
of ``racing_lmpc_torch`` and nothing in ``chip_smoke.py`` builds a path into
``racing_lmpc_tpu``: checked in the source (every string that names the
package is a ``file:line`` citation, or the tools' refusal list, which names
it only to refuse writing there) and while the loaders run (no file under
the JAX package is opened or listed), as the import check of
tests/test_torch_config.py runs the port in a process of its own.
"""

import ast
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from racing_lmpc_torch import config as tc

ROOT = Path(__file__).resolve().parent.parent
JAX_DATA = ROOT / "racing_lmpc_tpu" / "data"
PORT_SOURCES = sorted((ROOT / "racing_lmpc_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# a citation of the reference's code, as the kernels' "replaces" entries give it
CITATION = re.compile(r"racing_lmpc_tpu/[\w/]+\.py:\d+(-\d+)?")
# the tools' refusal list (racing_lmpc_torch/tools/__init__.py: PROTECTED)
REFUSAL_LIST = ROOT / "racing_lmpc_torch" / "tools" / "__init__.py"


def files_under(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p for p in sorted(root.rglob("*")) if p.is_file()}


def sha256(p: Path) -> str:
    return hashlib.sha256(p.read_bytes()).hexdigest()


def test_data_dir_lies_in_the_port():
    port = ROOT / "racing_lmpc_torch"
    for d in (tc.DATA_DIR, tc.PARAM_DIR, tc.TRACK_DIR, tc.SS_DIR):
        assert port in d.resolve().parents, d
        assert d.is_dir(), d


@pytest.mark.parametrize("part", ["params", "tracks", "ss", "lqr"])
def test_data_is_the_reference_data_byte_for_byte(part):
    mine, ref = files_under(tc.DATA_DIR / part), files_under(JAX_DATA / part)
    assert ref, part
    assert sorted(mine) == sorted(ref)
    assert {k: sha256(p) for k, p in mine.items()} == {k: sha256(p) for k, p in ref.items()}


def test_tools_refuse_to_write_the_data():
    from racing_lmpc_torch.tools import writable
    for p in (tc.DATA_DIR, tc.SS_DIR / "putnam_short"):
        with pytest.raises(ValueError, match="reference"):
            writable(p)


def test_data_holds_no_other_part():
    assert sorted(p.name for p in tc.DATA_DIR.iterdir()) == sorted(
        p.name for p in JAX_DATA.iterdir())


def _docstrings(tree) -> set:
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                ids.add(id(body[0].value))
    return ids


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_source_names_a_path_into_the_jax_package(path):
    tree = ast.parse(path.read_text())
    docs = _docstrings(tree)
    bad = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "racing_lmpc_tpu" in node.value and id(node) not in docs):
            v = node.value
            if CITATION.fullmatch(v) or (path == REFUSAL_LIST and v == "racing_lmpc_tpu"):
                continue
            bad.append((node.lineno, v[:80]))
    assert not bad, bad


# the loaders of every data file the port ships, run in a process of its own
# with an audit hook on every open and directory listing
_OPENS = r"""
import json, sys
seen = []
def hook(event, args):
    if event in ("open", "os.listdir", "os.scandir", "glob.glob") and args:
        seen.append(str(args[0]))
sys.addaudithook(hook)
import numpy as np
from racing_lmpc_torch import config as tc
from racing_lmpc_torch.launch.runner import _SCENARIOS
from racing_lmpc_torch.safeset import SafeSetManager, SafeSetRecorder
from racing_lmpc_torch.track import RacingTrajectory
for p in sorted(tc.PARAM_DIR.glob("*.yaml")):
    tc.load_ros_params(p)
tc.barc_vehicle(); tc.iac_vehicle(); tc.hawaii_gokart_vehicle(); tc.sample_vehicle()
for f in sorted(tc.TRACK_DIR.rglob("*.txt")):
    RacingTrajectory.from_file(f, device="cpu")
for spec in _SCENARIOS.values():
    tc.load_ros_params(tc.PARAM_DIR / spec.vehicle_base_yaml,
                       tc.PARAM_DIR / spec.vehicle_model_yaml, tc.PARAM_DIR / spec.mpc_yaml)
    if spec.load_laps:
        SafeSetRecorder(SafeSetManager(3, nx=6, use_native=False)).load(spec.load_laps, 100.0)
for f in sorted((tc.DATA_DIR / "lqr").glob("*.txt")):
    np.loadtxt(f)
import chip_smoke
chip_smoke.dt_lmpc_problem("dt_lmpc_iac_n10_b4", "cpu")
print(json.dumps(seen))
"""


def test_loaders_open_nothing_of_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _OPENS], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    seen = [Path(p) for p in json.loads(r.stdout.strip().splitlines()[-1])]
    jax_pkg = (ROOT / "racing_lmpc_tpu").resolve()
    bad = [str(p) for p in seen if jax_pkg == p.resolve() or jax_pkg in p.resolve().parents]
    assert not bad, bad[:10]
    data = tc.DATA_DIR.resolve()
    read = {p.resolve() for p in seen if data in p.resolve().parents}
    # every part of the data was read from the port's copy
    for part in ("params", "tracks", "ss", "lqr"):
        assert any((data / part) in p.parents for p in read), part
