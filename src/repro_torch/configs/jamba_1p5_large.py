"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887; hf].

72L, d_model 8192, 64 heads GQA kv=8, d_ff 24576, vocab 65536, MoE 16
experts top-2 on every second layer. Block unit = 8 layers: one attention
layer per 7 mamba layers; MoE/dense FFN alternates layer-by-layer.
Runs the long_500k cell (9 attention layers -> 500k KV is shardable).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_UNIT = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    vocab=65536,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    n_experts=16,
    top_k=2,
    expert_d_ff=24576,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_chunk=256,
    unit=_UNIT,
    tie_embeddings=False,
    use_rope=False,           # Jamba uses no positional encoding in attn layers
    param_dtype="bfloat16",
    optimizer="adafactor",
)
