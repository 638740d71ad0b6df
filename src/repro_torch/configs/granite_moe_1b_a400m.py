"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,               # per-expert hidden dim (spec)
    vocab_size=49155,
    head_dim=64,
    rope_theta=1e4,
    n_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    capacity_factor=1.25,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
