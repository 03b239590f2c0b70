"""deepseek-67b — llama-arch dense [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=True,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(48, 72)),
)
