"""paper-tiny — the ~100M-parameter end-to-end training config used by
`examples/train_lm.py`. Small enough for a few hundred CPU steps; exercises
the hash-dedup data plane exactly as the production configs do.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paper-tiny",
    n_layers=8,
    d_model=512,
    vocab=8192,
    n_heads=8,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    unit=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    q_chunk=128,
    kv_chunk=128,
    param_dtype="float32",
    activation_dtype="float32",
)
