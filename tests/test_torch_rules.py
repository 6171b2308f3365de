"""Guards of the PyTorch/CUDA port's ground rules.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package, and the port imports with JAX unavailable;
* the kernel path never falls back: ``impl="kernel"`` on a CPU tensor
  raises, a failed kernel build raises, and a tensor on a device with no
  kernel raises;
* entry points default to the card.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.dedup import DedupConfig
from repro_torch.kernels import _build, api, sketch_fused, stream
from repro_torch.kernels.plan import HashSpec, MinHashSpec, SketchPlan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "repro")
_PLAN = SketchPlan(HashSpec(family="cyclic", n=8),
                   (("sig", MinHashSpec(k=16)),))
_OPS = {"sig": {"a": np.arange(1, 33, 2, dtype=np.uint32),
                "b": np.arange(16, dtype=np.uint32)}}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in _FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_unavailable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.data.dedup, repro_torch.convert\n"
            "import repro_torch.kernels.stream\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_kernel_impl_on_cpu_raises():
    x = np.zeros((2, 40), np.uint32)
    with pytest.raises(ValueError, match="impl='kernel'"):
        api.run(_PLAN, x, operands=_OPS, impl="kernel", device="cpu")
    state = stream.init_state(_PLAN, 2, device="cpu")
    with pytest.raises(ValueError, match="impl='kernel'"):
        stream.update_many(_PLAN, state, x[None], operands=_OPS,
                           impl="kernel")


def test_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: "/bin/false")
    before = sketch_fused.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed for sketch_plan.cu"):
        _build.load("sketch_plan")
    assert sketch_fused.LAUNCHES == before
    assert not list(tmp_path.iterdir())
    assert "sketch_plan" not in _build._libs

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(_build.sources())


def test_wrapper_has_no_fallback_off_cpu():
    x = torch.zeros((2, 40), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        sketch_fused.sketch_plan_fused(
            x, None, torch.zeros((2,), dtype=torch.int32, device="meta"),
            {}, plan=_PLAN)


def test_entry_points_default_to_the_card():
    assert DedupConfig().device == "cuda"
    assert api.resolve_device(np.zeros(3)) == torch.device("cuda")
    assert api.resolve_device(torch.zeros(3)) == torch.device("cpu")
    assert "sketch_plan" in _build.sources()
