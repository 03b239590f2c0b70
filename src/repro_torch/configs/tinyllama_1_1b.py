"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=True,
    elastic=ElasticConfig(width_fractions=(0.25, 0.5, 1.0), exit_layers=(11, 16)),
)
