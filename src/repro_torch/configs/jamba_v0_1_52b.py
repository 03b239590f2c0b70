"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Period-8 layer pattern with attention at position 4 (1 attn : 7 mamba), MoE on
every other layer (moe_period=2). The 8-layer period is one scanned group, so
depth morphing exits at period boundaries (4 groups total).
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig

_PATTERN = ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=False,  # jamba uses no positional encoding (mamba provides order)
    layer_pattern=_PATTERN,
    n_experts=16,
    top_k=2,
    moe_period=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(2, 3)),
)
