"""dbrx-132b [moe] — 16-expert top-4 fine-grained MoE
[hf:databricks/dbrx-base; unverified].

40L, d_model 6144, 48 heads GQA kv=8, expert d_ff 10752, vocab 100352,
MoE on every layer.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    vocab=100352,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    n_experts=16,
    top_k=4,
    expert_d_ff=10752,
    unit=(LayerSpec("attn", "moe"),),
    tie_embeddings=False,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
)
