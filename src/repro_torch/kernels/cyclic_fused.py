"""DEPRECATED module shim: the fused byte->fingerprint kernel's wrapper
lives in :mod:`repro_torch.kernels.sketch_fused`.

``cyclic_rolling_fused`` (the h1 table lookup fused into the rolling CYCLIC
window hash, ``csrc/rolling.cu``) sits beside the plan kernel's wrapper, as
in the JAX package. This module re-exports it, and ``SIGMA``, for old
import sites and warns once a process; ``ops.cyclic_fused`` is the public
entry point.
"""
from __future__ import annotations

import warnings

from repro_torch.kernels.sketch_fused import (SIGMA,  # noqa: F401
                                              cyclic_rolling_fused)

warnings.warn(
    "repro_torch.kernels.cyclic_fused is deprecated; import "
    "cyclic_rolling_fused from repro_torch.kernels.sketch_fused or call "
    "ops.cyclic_fused",
    DeprecationWarning, stacklevel=2)
