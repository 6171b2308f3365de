"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].

64L, d_model 2560 (d_inner 5120, 80 heads x headdim 64), ssm_state 128,
vocab 50280. Runs the long_500k cell: SSM state is O(1) in sequence length.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    vocab=50280,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    unit=(LayerSpec("mamba", "none"),),
    tie_embeddings=True,
    use_rope=False,
    param_dtype="bfloat16",
)
