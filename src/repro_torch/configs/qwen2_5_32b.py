"""qwen2.5-32b [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B (family card, 32B variant)",
)
