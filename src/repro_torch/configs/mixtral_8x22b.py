"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf].

The assignment specifies SWA; window 4096 (Mistral lineage). This is what makes
the arch sub-quadratic and eligible for the long_500k cell (rolling KV window).
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,  # per-expert hidden dim
    vocab_size=32768,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=True,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    moe_period=1,  # every layer is MoE
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(28, 42)),
)
