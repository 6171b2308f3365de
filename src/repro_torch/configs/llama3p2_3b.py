"""llama3.2-3b [dense] — small llama3, GQA kv=8
[hf:meta-llama/Llama-3.2-1B; unverified].

28L, d_model 3072, 24 heads kv=8 head_dim 128, d_ff 8192, vocab 128256.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    vocab=128256,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    unit=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    rope_theta=500_000.0,
)
