"""whisper-medium [audio] — encoder-decoder, conv frontend STUBBED
[arXiv:2212.04356]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # MHA
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    rope_theta=0.0,         # learned positions, no RoPE
    is_encoder_decoder=True,
    encoder_seq=1500,       # 30 s of audio at 50 Hz after conv stride 2
    max_target_positions=448,
    modality="audio",
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2212.04356 (Whisper)",
)
