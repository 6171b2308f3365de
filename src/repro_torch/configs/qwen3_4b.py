"""qwen3-4b [dense] — qk-norm, GQA kv=8, head_dim 128 (q-dim 4096 > d_model)
[hf:Qwen/Qwen3-8B; hf].

36L, d_model 2560, 32 heads kv=8, d_ff 9728, vocab 151936.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    vocab=151936,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=9728,
    unit=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
