"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, which is loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of their source, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed build raises: there is no
fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# the compiler's report (ptxas registers, shared memory, spills) per kernel
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then the
    toolkit's usual home."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, or the ``.cu`` file that ``name`` is the path of
    (a measurement kernel kept outside the package)."""
    return Path(name) if name.endswith(".cu") else CSRC / f"{name}.cu"


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _compile(name: str) -> Path:
    """nvcc one source into its library (atomically renamed into place)."""
    src = _source(name)
    out = _target(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    BUILD_LOG[src.stem] = proc.stderr
    os.replace(tmp, out)
    return out


def build(names: Iterable[str]) -> None:
    """Compile and load each named kernel (a ``csrc`` name or a ``.cu``
    path) that is not loaded yet: one nvcc per source, all started
    together, so a cold build takes about as long as its slowest source
    however many sources the port grows."""
    todo = [name for name in dict.fromkeys(names) if name not in _libs]
    if not todo:
        return
    with ThreadPoolExecutor(len(todo)) as pool:
        paths = list(pool.map(_compile, todo))
    for name, path in zip(todo, paths):
        _libs[name] = ctypes.CDLL(str(path))


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or for the ``.cu`` path
    ``name``), built on first use."""
    if name not in _libs:
        build([name])
    return _libs[name]
