"""The port stands alone: no JAX, nothing of the reference package, and no
silent fallback to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    benchmarks = sorted((ROOT / "benchmarks").glob("torch_*.py"))
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + benchmarks


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 10
    scenario_files = {f.name for f in files if f.parent == PORT / "scenarios"}
    assert scenario_files == {"__init__.py", "registry.py", "catalog.py", "faults.py", "grouping.py"}
    bad = [(f.name, m) for f in files for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


def test_importing_every_port_module_leaves_jax_out():
    modules = [
        ".".join(f.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for f in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")


def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card, tmp_path):
    from repro_torch import resolve_device
    from repro_torch.checkpoint import ExtractorSpec, init_artifact, load_artifact
    from repro_torch.launch import vfl_step
    from repro_torch.launch.vfl_serve import ServingEngine, main

    specs = [ExtractorSpec("mlp", 4, hidden=(8,))] * 2
    art = init_artifact(specs, [(3,), (3,)], 2, seed=0, device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(art, capacity=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_artifact(specs, [(3,), (3,)], 2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--artifact", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vfl_step.main([])  # before any party process is spawned
    # an engine on the CPU serves the CPU artifact
    logits = ServingEngine(art, capacity=4, device="cpu").predict_logits([torch.zeros(5, 3)] * 2)
    assert logits.shape == (5, 2)


def test_only_cpu_tensors_take_the_plain_version(monkeypatch):
    """Any other device launches the kernel or raises; it never falls back."""
    from repro_torch.kernels.sdpa_estimator import ops, ref

    monkeypatch.setattr(ref, "sdpa_estimate_batched", lambda *a: pytest.fail("plain route taken"))
    q = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no SDPA route"):
        ops.sdpa_estimate_batched(q, q, q)


def test_kernel_build_without_nvcc_raises():
    from repro_torch.kernels import _build

    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(no_card, alone, tmp_path):
    """No CUDA device (or no port package beside it): nonzero exit and no
    result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    cmd = [sys.executable, str(script)]
    proc = subprocess.run(cmd, cwd=script.parent, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
