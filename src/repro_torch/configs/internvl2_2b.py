"""internvl2-2b — InternViT frontend (stub) + InternLM2-1.8b backbone
[arXiv:2404.16821; hf].

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (batch, 256, 1024), linearly projected to d_model
and prepended to the token sequence (text length = seq_len - 256).
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    activation="swiglu",
    norm="rmsnorm",
    use_rope=True,
    frontend="vision_stub",
    frontend_seq=256,
    frontend_dim=1024,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(12, 18)),
)
