"""mamba2-370m — attention-free SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # pure mamba stack: no MLP sub-block
    vocab_size=50280,
    norm="rmsnorm",
    use_rope=False,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(24, 36)),
)
