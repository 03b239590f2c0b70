"""nemotron-4-340b — dense GQA, squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",  # up/down MLP (2 matrices), per Nemotron-4
    norm="layernorm",
    use_rope=True,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(48, 72)),
)
