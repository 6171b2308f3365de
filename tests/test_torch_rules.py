"""Guards of the PyTorch/CUDA port's ground rules.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package, and the port imports with JAX unavailable;
* the kernel path never falls back: ``impl="kernel"`` on a CPU tensor
  raises, a failed kernel build raises, and a tensor on a device with no
  kernel raises;
* entry points default to the card;
* the byte path's wrappers (``bloom_probe``, ``hll_update``, which take no
  ``impl``) run their plain version on a CPU tensor only, and
  ``make_family`` builds all five families.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.decontam import DecontamConfig
from repro_torch.data.dedup import DedupConfig
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.data.stats import StatsConfig
from repro_torch.core import FAMILIES, make_family
from repro_torch.kernels import (_build, api, bloom, decode, hll, ops, ref,
                                 sketch_fused, stream)
from repro_torch.kernels.plan import (DecodeSpec, HashSpec, MinHashSpec,
                                      SketchPlan)

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
            "import repro_torch.kernels.stream, repro_torch.kernels.ops\n"
            "import repro_torch.data.stats, repro_torch.data.decontam\n"
            "import repro_torch.data.pipeline\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.configs.registry, repro_torch.nn.lm\n"
            "import repro_torch.core.independence\n"
            "import repro_torch.kernels.bloom, repro_torch.kernels.hll\n"
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
    from repro_torch.serve.sessions import SessionPool
    spec = DecodeSpec(n=3, log2_m=6)
    with pytest.raises(ValueError, match="impl='kernel'"):
        SessionPool(spec, 2, torch.zeros(40, dtype=torch.uint32),
                    impl="kernel")
    with pytest.raises(ValueError, match="impl='kernel'"):
        api.decode(spec, np.zeros((2, 40), np.float32), np.zeros(2),
                   np.ones(2, bool), np.zeros((2, 2), np.uint32),
                   np.zeros(40, np.uint32), impl="kernel", device="cpu")
    before = sketch_fused.LOOKUP_LAUNCHES
    with pytest.raises(ValueError, match="impl='kernel'"):
        ops.cyclic_fused(torch.zeros((2, 40), dtype=torch.int32),
                         torch.zeros(256, dtype=torch.uint32), n=8,
                         impl="kernel")
    assert sketch_fused.LOOKUP_LAUNCHES == before


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
    before = decode.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        decode.decode_masks_fused(x.view(torch.int32).float(), None, None,
                                  None, None, spec=DecodeSpec())
    assert decode.LAUNCHES == before
    before = sketch_fused.LOOKUP_LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        sketch_fused.cyclic_rolling_fused(
            x.view(torch.int32), torch.zeros(256, dtype=torch.uint32,
                                             device="meta"), n=8)
    assert sketch_fused.LOOKUP_LAUNCHES == before


def test_byte_path_wrappers_dispatch_by_device_only():
    """bloom_probe and hll_update take no impl: the plain version on a CPU
    tensor (no launch counted), the kernel on a CUDA tensor, and a raise on
    any other device."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.integers(0, 1 << 32, (2, 50), dtype=np.uint32))
    bits = torch.from_numpy(rng.integers(0, 1 << 32, 1 << 9,
                                         dtype=np.uint32))
    b0, h0 = bloom.LAUNCHES, hll.LAUNCHES
    assert torch.equal(bloom.bloom_probe(h, h, bits, k=2, log2_m=14),
                       ref.bloom_probe_ref(h, h, bits, k=2, log2_m=14))
    assert torch.equal(hll.hll_update(h, b=6),
                       ref.hll_update_ref(h, b=6))
    assert (bloom.LAUNCHES, hll.LAUNCHES) == (b0, h0)
    meta = h.to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        bloom.bloom_probe(meta, meta, bits.to("meta"), k=2, log2_m=14)
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        hll.hll_update(meta, b=6)
    assert (bloom.LAUNCHES, hll.LAUNCHES) == (b0, h0)


def test_byte_path_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels "
                    "there)")
    h = torch.arange(4096, dtype=torch.int64).to(torch.uint32).cuda()
    b0, h0, l0 = bloom.LAUNCHES, hll.LAUNCHES, sketch_fused.LOOKUP_LAUNCHES
    bloom.bloom_probe(h[None], h[None],
                      torch.zeros(1 << 9, dtype=torch.uint32, device="cuda"),
                      log2_m=14)
    hll.hll_update(h, b=8)
    ops.cyclic_fused(torch.zeros((1, 64), dtype=torch.int32, device="cuda"),
                     torch.zeros(256, dtype=torch.uint32, device="cuda"), n=8)
    assert (bloom.LAUNCHES, hll.LAUNCHES, sketch_fused.LOOKUP_LAUNCHES) == (
        b0 + 1, h0 + 1, l0 + 1)


def test_make_family_builds_all_five():
    assert sorted(FAMILIES) == ["buffered_general", "cyclic", "general",
                                "id37", "threewise"]
    for name in FAMILIES:
        fam = make_family(name, 4, 16)
        params = fam.init(torch.Generator().manual_seed(0), 32, "cpu")
        assert fam.hash_windows(params, torch.arange(10)).shape == (7,)


def test_entry_points_default_to_the_card():
    for cfg in (DedupConfig, StatsConfig, DecontamConfig, PipelineConfig):
        assert cfg().device == "cuda", cfg
    assert api.resolve_device(np.zeros(3)) == torch.device("cuda")
    assert api.resolve_device(torch.zeros(3)) == torch.device("cpu")
    assert {"sketch_plan", "rolling", "decode", "bloom", "hll"} <= set(
        _build.sources())
    import inspect

    from repro_torch.nn import lm
    from repro_torch.serve import engine, sessions
    for fn in (lm.init, lm.init_caches, engine.NoRepeatNgram.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    pool = inspect.signature(sessions.SessionPool.__init__).parameters
    assert pool["device"].default is None      # h1's device, else cuda
    assert api.resolve_device(np.zeros(3), pool["device"].default) == \
        torch.device("cuda")
    from repro_torch.launch import serve
    assert "default=\"cuda\"" in inspect.getsource(serve.main)


class _Stop(Exception):
    pass


def test_byte_path_entry_point_defaults_to_the_card(monkeypatch):
    """ops.cyclic_fused sends an array to cuda unless told otherwise."""
    seen = []

    def spy(impl, dev):
        seen.append(torch.device(dev))
        raise _Stop
    monkeypatch.setattr(api, "use_ref", spy)
    toks, table = np.zeros((1, 8), np.int32), np.zeros(256, np.uint32)
    with pytest.raises(_Stop):
        ops.cyclic_fused(toks, table, n=2)
    with pytest.raises(_Stop):
        ops.cyclic_fused(toks, table, n=2, device="cpu")
    assert seen == [torch.device("cuda"), torch.device("cpu")]
