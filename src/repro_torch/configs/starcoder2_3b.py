"""starcoder2-3b [dense] — GQA kv=2, RoPE, native 4k sliding window
[arXiv:2402.19173]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    rope_theta=1e5,
    qkv_bias=True,
    sliding_window=4096,    # StarCoder2 trains with SWA
    act="gelu",
    norm_type="layernorm",
    source="arXiv:2402.19173 (StarCoder2)",
)
