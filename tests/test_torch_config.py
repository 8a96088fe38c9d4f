"""Port configuration and packaging: the port's own ROS-param YAML reader
against the JAX package's PyYAML-based ``load_ros_params`` on every shipped
param file, configs carried across, import hygiene, and the CUDA default of
the entry points."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import racing_lmpc_tpu.config as jc
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.carry import config_from_dict, mpc_input_from_arrays

ROOT = Path(__file__).resolve().parent.parent
PARAM_FILES = sorted((ROOT / "racing_lmpc_tpu" / "data" / "params").glob("*.yaml"))


def _numbers_as_parsed(v):
    """The JAX package's reading after the ``_clean_inf`` of its ``*_from_params`` functions: YAML
    1.1 leaves exponent literals such as ``1e-3`` as strings, which the
    functions turn into floats (config.py:315-328); the port's reader returns
    them as numbers directly."""
    if isinstance(v, dict):
        return {k: _numbers_as_parsed(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_numbers_as_parsed(x) for x in v]
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def test_all_param_files_are_covered():
    assert len(PARAM_FILES) == 25


@pytest.mark.parametrize("path", PARAM_FILES, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml(path):
    assert tc.load_ros_params(path) == _numbers_as_parsed(jc.load_ros_params(path))


@pytest.mark.parametrize("text", [
    "a:\n\tb: 1\n", "a: [1, 2\n", "- 1\n", "a:\n  b: 1\n  - 2\n", "just text\n"])
def test_yaml_reader_rejects_unsupported_input(text):
    with pytest.raises(ValueError):
        tc.parse_ros_yaml(text)


def test_config_functions_match_and_configs_carry_across():
    pairs = [(tc.barc_vehicle()[0], jc.barc_vehicle()[0]),
             (tc.barc_vehicle()[1], jc.barc_vehicle()[1])]
    for name in ("barc_lmpc", "barc_tracking_mpc"):
        pairs.append((tc.barc_mpc_config(name, n=20), jc.barc_mpc_config(name, n=20)))
    for port_cfg, jax_cfg in pairs:
        d = dataclasses.asdict(jax_cfg)
        assert dataclasses.asdict(port_cfg) == d
        assert config_from_dict(type(port_cfg), d) == port_cfg
    with pytest.raises(ValueError):
        config_from_dict(tc.SteerConfig, {"no_such_field": 1.0})


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import pkgutil, sys, importlib, racing_lmpc_torch\n"
        "for m in pkgutil.walk_packages(racing_lmpc_torch.__path__, 'racing_lmpc_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'racing_lmpc_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('racing_lmpc_torch')]), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 15 and out[1:] == ["[]"]


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "racing_lmpc_tpu"}
    assert "racing_lmpc_torch" in roots


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.models import SingleTrackPlanarModel
    from racing_lmpc_torch.mpc.racing_mpc import RacingMPC
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_barc_lmpc()
    _, track, cfg, mpc, manager = build_barc_lmpc(5, 8, 4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scenario_batch(mpc, track, manager, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RacingMPC(cfg, SingleTrackPlanarModel(*tc.barc_vehicle()))
    arrays = {k: v.numpy() for k, v in
              make_scenario_batch(mpc, track, manager, 2, device="cpu")._asdict().items()
              if v is not None}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpc_input_from_arrays(arrays)
    assert mpc_input_from_arrays(arrays, device="cpu").x_ic.device.type == "cpu"


def test_numerics_policy():
    assert torch.get_default_dtype() == torch.float32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
