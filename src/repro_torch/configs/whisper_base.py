"""whisper-base — encoder-decoder audio backbone, conv frontend stubbed
[arXiv:2212.04356; unverified].

The modality frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (batch, 1500, 512). Shapes cells apply to the
decoder; the encoder length is fixed at 1500 (30s of audio at 50 fps).
"""
from repro_torch.configs.base import ElasticConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    use_rope=False,  # sinusoidal/learned absolute positions
    enc_layers=6,
    enc_seq=1500,
    frontend="audio_stub",
    frontend_seq=1500,
    frontend_dim=512,
    elastic=ElasticConfig(width_fractions=(0.5, 1.0), exit_layers=(3,)),
)
