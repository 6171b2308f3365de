"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA-as-GQA(kv=32)
[arXiv:2404.14219; unverified].

32L, d_model 3072, 32 heads kv=32 (full MHA), d_ff 8192, vocab 32064.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32,
    d_model=3072,
    vocab=32064,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    unit=(LayerSpec("attn", "dense"),),
    tie_embeddings=False,
    rope_theta=10_000.0,
)
