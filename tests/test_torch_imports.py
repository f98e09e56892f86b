"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the ``repro`` package, and the port's entry points refuse
to slide onto the CPU when no CUDA device is present."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import bridge, configs
from repro_torch.launch import serve as launcher
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.serve.scheduler" in mods and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_import_in_the_source():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_seeds.py"]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)} imports {name}")


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "model": lambda cfg: Model(cfg),
    "bridge": lambda cfg: bridge.params_from_jax(cfg, {}),
    "tables": lambda cfg: bridge.tables_from_jax([]),
    "launcher": lambda cfg: launcher.main(["--reduced", "--demo", "--quiet"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_refuse_cpu_unless_asked(no_cuda, entry):
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
