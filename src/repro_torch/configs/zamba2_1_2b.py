"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,          # shared attn block is MHA
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    rope_theta=1e4,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,           # one shared attention block every 6 layers
    source="arXiv:2411.15242 (Zamba2)",
)
