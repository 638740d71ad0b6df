"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay
[arXiv:2404.05892]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=0.0,
    source="arXiv:2404.05892 (RWKV6 / Finch)",
)
