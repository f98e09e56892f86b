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
from repro_torch.core import peft as peft_mod
from repro_torch.launch import export as exporter
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.model import Model
from repro_torch.train.loop import TrainLoop

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.serve.scheduler" in mods and len(mods) >= 20
    for m in ("data.pipeline", "data.tasks", "data.tokenizer", "optim.adamw",
              "optim.schedules", "train.step", "train.loop", "launch.train",
              "tree", "checkpoint.manager", "launch.export",
              "configs.olmo_1b", "configs.qwen2p5_14b",
              "configs.h2o_danube_1p8b", "configs.qwen3_moe_30b_a3b",
              "configs.llama4_maverick_400b_a17b", "models.moe",
              "configs.recurrentgemma_9b", "configs.xlstm_350m",
              "models.recurrent", "models.xlstm", "configs.paligemma_3b",
              "configs.hubert_xlarge", "distrib.axes", "distrib.sharding",
              "launch.mesh", "checkpoint.reshard", "optim.compression",
              "launch.specs", "launch.dryrun", "roofline",
              "roofline.analysis", "analysis", "analysis.base",
              "analysis.callgraph", "analysis.catalog", "analysis.enums",
              "analysis.lifecycle", "analysis.purity", "analysis.rng",
              "analysis.runner", "analysis.__main__"):
        assert f"repro_torch.{m}" in mods, m
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
    files += [ROOT / "chip_smoke.py", ROOT / "chip_seeds.py",
              ROOT / "chip_ab.py", ROOT / "chip_trace.py"]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)} imports {name}")


def test_the_linter_imports_the_standard_library_only():
    """``repro_torch.analysis`` runs without torch, jax or the reference:
    each of its modules imports the standard library and its own package
    alone, and importing it in a fresh process loads no torch."""
    pkg = ROOT / "src" / "repro_torch" / "analysis"
    files = sorted(pkg.glob("*.py"))
    assert len(files) >= 10
    for path in files:
        for name in _imports(path):
            assert name == "__future__" or name.startswith(
                "repro_torch.analysis") or name.split(".")[0] in \
                sys.stdlib_module_names, f"{path.name} imports {name}"
    code = ("import sys\n"
            "import repro_torch.analysis.runner\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch', 'numpy')!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "model": lambda cfg: Model(cfg),
    "bridge": lambda cfg: bridge.params_from_jax(cfg, {}),
    "tables": lambda cfg: bridge.tables_from_jax([]),
    "launcher": lambda cfg: launcher.main(["--reduced", "--demo", "--quiet"]),
    "peft": lambda cfg: peft_mod.init(cfg, peft_mod.PEFTOptions()),
    "train_launcher": lambda cfg: train_launcher.main(["--reduced",
                                                       "--steps", "1"]),
    # a mesh on CUDA refuses before it spawns a rank or joins a group
    "train_launcher_mesh": lambda cfg: train_launcher.main(
        ["--reduced", "--steps", "1", "--mesh", "1x1"]),
    "mesh_group": lambda cfg: mesh_mod.init_group(0, 1, "cuda"),
    "train_loop": lambda cfg: TrainLoop(train_step=None, frozen={},
                                        stream=None),
    "export": lambda cfg: exporter.main(["--reduced"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_refuse_cpu_unless_asked(no_cuda, entry):
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2.5-14b",
                                  "h2o-danube-1.8b", "qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_decoder_configs_refuse_cpu_unless_asked(no_cuda, name):
    """Each decoder config module registers its config; its model and
    launchers raise without CUDA unless the CPU is asked for."""
    cfg = configs.reduced(configs.get(name), repeats=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--reduced", "--demo", "--quiet", "--arch", name,
                       "--layout", "slots"])
    assert Model(cfg, device="cpu").device.type == "cpu"
