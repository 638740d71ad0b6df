"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8, GQA kv=8
[arXiv:2501.kimi2 paper-table]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,              # per-expert hidden dim (spec)
    vocab_size=163840,
    head_dim=112,           # 7168 / 64
    rope_theta=5e4,
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    n_shared_experts=1,     # K2 keeps one shared expert
    capacity_factor=1.25,
    source="arXiv:2501.kimi2 (Kimi K2)",
)
