"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (vision tower STUBBED)
[arXiv:2409.12191]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),  # t/h/w bands of head_dim//2 = 64
    modality="vision",
    source="arXiv:2409.12191 (Qwen2-VL)",
)
