"""Hygiene of the port: it stands alone (no JAX, nothing of ``repro``), its
entry points never drop to the CPU on their own, and it turns TF32 off."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import api, covariance as cov, support
from repro_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_no_jax_and_nothing_of_repro():
    mods = _port_modules()
    assert {"repro_torch.core.ppitc", "repro_torch.core.ppic",
            "repro_torch.core.pitc", "repro_torch.core.clustering",
            "repro_torch.core.picf", "repro_torch.core.hyper",
            "repro_torch.optim.adam", "repro_torch.core.online",
            "repro_torch.kernels.rbf.ops", "repro_torch.kernels.linalg.ops",
            "repro_torch.kernels.linalg.ref",
            "repro_torch.launch.routed_profile",
            "repro_torch.runtime.fault", "repro_torch.runtime.straggler",
            "repro_torch.runtime.elastic",
            "repro_torch.kernels.attention.ops", "repro_torch.kernels.ssd.ops",
            "repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.launch.serve",
            "repro_torch.configs.registry", "repro_torch.core.serialize",
            "repro_torch.launch.gp_serve", "repro_torch.serving",
            "repro_torch.serving.stats", "repro_torch.serving.health",
            "repro_torch.serving.chaos", "repro_torch.serving.registry",
            "repro_torch.serving.scheduler",
            "repro_torch.runtime.monitor", "repro_torch.launch.mesh",
            "repro_torch.launch.backend_probe",
            "repro_torch.parallel.collectives",
            "repro_torch.optim.compression",
            "repro_torch.checkpoint.io", "repro_torch.checkpoint.manager",
            "repro_torch.parallel.sharding", "repro_torch.data.loader",
            "repro_torch.launch.train", "repro_torch.launch.scheduler",
            "repro_torch.configs.shapes", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun", "repro_torch.roofline.hw",
            "repro_torch.roofline.kernels", "repro_torch.roofline.analysis",
            "repro_torch.roofline.report", "repro_torch.roofline.rescore",
            "repro_torch.analysis", "repro_torch.analysis.engine",
            "repro_torch.analysis.rules", "repro_torch.analysis.contracts",
            "repro_torch.analysis.__main__"} \
        <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_nothing_of_repro():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "msgpack"}


def test_port_sources_import_no_jax_and_nothing_of_repro():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro",
                                             "msgpack"}, path


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = torch.zeros(8, 2), torch.zeros(8)
    params = cov.init_params(2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fit("fgp", cov.make_kernel("se"), params, X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_store("pitc", cov.make_kernel("se"), params, X, y,
                       S=X[:2], M=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.aimpeak_like(n=8, n_test=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        support.select_support(cov.make_kernel("se"), params, X, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cov.init_params(2)


def test_cuda_impl_on_cpu_tensors_raises():
    params = cov.init_params(2, device="cpu")
    X = torch.zeros(4, 2)
    spec = cov.make_spec("se", impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        spec(params, X, X)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        spec.fused_diag(params, X, X, torch.eye(4), torch.zeros(4))


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
