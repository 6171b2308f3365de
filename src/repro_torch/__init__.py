"""PyTorch/CUDA port of the ``repro`` package.

The JAX package under ``src/repro`` is the reference; this package mirrors
its layout (``core/``, ``kernels/``, ``data/``) and is held bit-exact
against it by ``tests/test_torch_*.py``. It imports ``torch`` and numpy,
never ``jax`` or ``repro``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on a CUDA tensor the hot path launches the
hand-written kernels under ``kernels/csrc/``, on a CPU tensor it takes their
plain PyTorch versions.
"""
