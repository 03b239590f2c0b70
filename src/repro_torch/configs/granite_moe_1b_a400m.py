"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,  # per-expert hidden dim
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=True,
    n_experts=32,
    top_k=8,
    moe_period=1,
    tie_embeddings=True,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(12, 18)),
)
