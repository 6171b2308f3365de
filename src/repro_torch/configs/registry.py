"""Architecture registry: ``--arch <id>`` resolution + per-arch shape rules."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (dbrx_132b, jamba_1p5_large, kimi_k2_1t,
                                 llama3p2_3b, mamba2_2p7b, musicgen_large,
                                 paligemma_3b, paper_tiny, phi3_mini,
                                 qwen1p5_0p5b, qwen3_4b)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (paligemma_3b, dbrx_132b, kimi_k2_1t, mamba2_2p7b,
              jamba_1p5_large, phi3_mini, qwen3_4b, qwen1p5_0p5b,
              llama3p2_3b, musicgen_large, paper_tiny)
}

ASSIGNED: List[str] = [n for n in ARCHS if n != "paper-tiny"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


# §Perf-validated production overrides (EXPERIMENTS.md §Perf). Baseline
# configs stay as-published so the dry-run artifacts remain reproducible;
# apply these for deployment: `dataclasses.replace(get_config(a),
# **RECOMMENDED[a])`.
RECOMMENDED = {
    "dbrx-132b": dict(moe_dispatch="grouped", remat="full",
                      num_microbatches=16, optimizer="adafactor"),
    "kimi-k2-1t-a32b": dict(moe_dispatch="grouped", remat="full",
                            num_microbatches=16),
    "jamba-1.5-large-398b": dict(moe_dispatch="grouped", remat="full",
                                 num_microbatches=8),
    "mamba2-2.7b": dict(remat="full", num_microbatches=8),
    # dense archs: causal block skipping is exact and strictly less work
    "phi3-mini-3.8b": dict(attn_causal_skip=True),
    "qwen3-4b": dict(attn_causal_skip=True),
    "qwen1.5-0.5b": dict(attn_causal_skip=True, ce_chunk_vocab=4752),
    "llama3.2-3b": dict(attn_causal_skip=True),
    "paligemma-3b": dict(attn_causal_skip=True),
    "musicgen-large": dict(attn_causal_skip=True),
}


def get_recommended_config(name: str) -> ModelConfig:
    import dataclasses
    return dataclasses.replace(get_config(name), **RECOMMENDED.get(name, {}))


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True if any layer avoids full attention growth (SSM/hybrid archs)."""
    return any(s.kind == "mamba" for s in cfg.unit)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rule: long_500k only runs for sub-quadratic archs
    (full-attention KV at 500k exceeds any per-chip HBM budget); decode
    shapes apply to every decoder-only arch (all 10 are decoder-only)."""
    if shape.name == "long_500k":
        return is_subquadratic(cfg)
    return True


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honouring the documented skips."""
    out = []
    for arch in ASSIGNED:
        cfg = ARCHS[arch]
        for shape in SHAPES.values():
            ok = shape_applicable(cfg, shape)
            if ok or include_skipped:
                out.append((arch, shape.name, ok))
    return out
