"""kimi-k2-1t-a32b [moe] — trillion-param fine-grained MoE, 32B active
[arXiv:2501.kimi2; unverified, paper-table].

61L, d_model 7168, 64 heads GQA kv=8, per-expert d_ff 2048, vocab 163840,
MoE 384 experts top-8 on every layer. At 512 chips this config requires
factored optimizer state (`adafactor`) — see DESIGN.md §8 / EXPERIMENTS.md.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    vocab=163840,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    n_experts=384,
    top_k=8,
    expert_d_ff=2048,
    capacity_factor=1.25,
    unit=(LayerSpec("attn", "moe"),),
    tie_embeddings=False,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
)
