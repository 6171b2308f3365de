"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

Backbone only: 48L, d_model 2048, 32 heads kv=32, d_ff 8192, vocab 2048.
The EnCodec frontend and the text-conditioning cross-attention are STUBS —
`input_specs()` provides 64 precomputed conditioning frame embeddings as a
prefix; the decoder operates on a single codebook stream (the delay-pattern
interleave is a data-pipeline concern, not a backbone one).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    vocab=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    mlp_gated=False,          # musicgen uses plain GELU MLP
    unit=(LayerSpec("attn", "dense"),),
    tie_embeddings=False,
    use_rope=False,           # learned/sinusoidal positions in the original
    prefix_len=64,
)
