"""Model and shape configuration dataclasses (a copy of the JAX package's
``repro/configs/base.py``, which imports no JAX; the port keeps its own).

Every architecture is a :class:`ModelConfig` built from a repeating *block
unit* (``unit`` layer specs x ``repeats``). The JAX package scans the unit
over its stacked parameters; the port holds one module per repeat
(:mod:`repro_torch.nn.lm`). The TPU hardware model of the reference
(``HardwareConfig``, ``V5E``) is not carried over: its constants are not
the card's.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence, Tuple

LayerKind = Literal["attn", "mamba"]
FfnKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating block unit."""
    kind: LayerKind = "attn"
    ffn: FfnKind = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    attn_logit_softcap: float = 0.0
    # dense ffn
    d_ff: int = 0
    mlp_gated: bool = True      # SwiGLU vs plain GELU MLP
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0        # per-expert hidden; 0 -> d_ff
    capacity_factor: float = 1.25
    router_softmax: bool = True
    # "global": one token pool, global-cumsum ranking (baseline — the scatter
    #   reduces the full dispatch buffer across data shards);
    # "grouped": per-batch-row ranking/capacity — dispatch stays shard-local
    #   (GShard group_size pattern; §Perf iteration)
    moe_dispatch: str = "global"
    # Mamba-2 (SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # §Perf iteration: constrain SSD intermediates to (batch->data,
    # heads->model) — off = baseline (partitioner left the O(S*c*H) decay
    # tensors replicated over `model`)
    ssd_constrain: bool = False
    # block program: `unit` repeated `repeats` times; len(unit)*repeats == n_layers
    unit: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # embeddings / stubs
    tie_embeddings: bool = True
    prefix_len: int = 0         # modality stub: # of precomputed prefix embeddings
    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # training
    remat: str = "dots"          # nothing | dots | full
    optimizer: str = "adamw"     # adamw | adafactor
    num_microbatches: int = 1    # gradient-accumulation microbatches
    # attention chunking (pure-JAX flash)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # §Perf iteration: per-q-chunk static KV ranges — skips fully-masked
    # (future) KV blocks instead of computing-then-masking them (≈2x less
    # attention work for causal shapes). Off = baseline.
    attn_causal_skip: bool = False
    # §Perf iteration: keep the online-softmax probability tensor in bf16
    # for the PV matmul (max/sum stats stay f32). Off = baseline (all-f32
    # score chain).
    attn_bf16_scores: bool = False
    # dry-run analysis: unroll the layer scan so HLO cost analysis counts
    # every repeat (XLA tallies while-loop bodies once); identical semantics
    scan_unroll: bool = False
    # §Perf iteration: compute the training CE by scanning vocab chunks of
    # the unembedding (never materializing the (B,S,V) f32 logits).
    # 0 = off (baseline).
    ce_chunk_vocab: int = 0
    # paper data-plane defaults
    ngram_n: int = 8
    hash_family: str = "cyclic"

    def __post_init__(self):
        assert self.n_layers == len(self.unit) * self.repeats, (
            f"{self.name}: n_layers={self.n_layers} != "
            f"{len(self.unit)}*{self.repeats}")

    # -- derived -----------------------------------------------------------
    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_expert_d_ff(self) -> int:
        return self.expert_d_ff or self.d_ff

    def layer_specs(self) -> Sequence[LayerSpec]:
        return list(self.unit) * self.repeats

    # -- parameter accounting (used by tests and the roofline) --------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _dense_ffn_params(self) -> int:
        mult = 3 if self.mlp_gated else 2
        return mult * self.d_model * self.d_ff

    def _moe_params(self) -> int:
        mult = 3 if self.mlp_gated else 2
        expert = mult * self.d_model * self.resolved_expert_d_ff
        router = self.d_model * self.n_experts
        return self.n_experts * expert + router

    def _moe_active_params(self) -> int:
        mult = 3 if self.mlp_gated else 2
        expert = mult * self.d_model * self.resolved_expert_d_ff
        return self.top_k * expert + self.d_model * self.n_experts

    def _mamba_params(self) -> int:
        di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * ns + hh)
        conv = (di + 2 * ns) * self.ssm_conv
        out_proj = di * self.d_model
        extra = 2 * hh + di  # A_log, dt_bias, D
        return in_proj + conv + out_proj + extra

    def param_count(self, active_only: bool = False) -> int:
        total = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        for spec in self.layer_specs():
            total += self.d_model * 2  # pre-norms
            if spec.kind == "attn":
                total += self._attn_params()
            else:
                total += self._mamba_params()
            if spec.ffn == "moe":
                total += self._moe_active_params() if active_only else self._moe_params()
            elif spec.ffn == "dense":
                total += self._dense_ffn_params()
        total += self.d_model  # final norm
        return total

    def model_flops_per_token(self) -> float:
        """6*N_active — the §Roofline MODEL_FLOPS convention."""
        return 6.0 * self.param_count(active_only=True)

    # -- reduced variant for CPU smoke tests --------------------------------
    def smoke(self) -> "ModelConfig":
        unit = self.unit
        scale = {
            "n_layers": len(unit) * 2,
            "d_model": 64,
            "vocab": 512,
            "n_heads": 4 if self.n_heads else 0,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            "head_dim": 16 if self.n_heads else 0,
            "d_ff": 128 if self.d_ff else 0,
            "n_experts": min(self.n_experts, 4),
            "top_k": min(self.top_k, 2),
            "expert_d_ff": 64 if self.n_experts else 0,
            "ssm_state": min(self.ssm_state, 16),
            "ssm_head_dim": 16 if self.ssm_state else 64,
            "ssm_chunk": 32,
            "prefix_len": min(self.prefix_len, 4),
            "q_chunk": 64,
            "kv_chunk": 64,
            "param_dtype": "float32",
            "activation_dtype": "float32",
        }
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
