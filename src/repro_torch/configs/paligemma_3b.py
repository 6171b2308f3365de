"""paligemma-3b [vlm] — SigLIP + Gemma backbone [arXiv:2407.07726; hf].

Backbone only (assignment rule): 18L, d_model 2048, 8 heads MQA (kv=1,
head_dim 256), d_ff 16384, vocab 257216. The SigLIP vision frontend is a
STUB — `input_specs()` supplies 256 precomputed patch embeddings per example
as a prefix (prefix-LM attention over the prefix, causal over text).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    vocab=257216,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    mlp_gated=True,           # gemma GeGLU
    unit=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
    prefix_len=256,           # SigLIP patch tokens (stubbed)
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)
