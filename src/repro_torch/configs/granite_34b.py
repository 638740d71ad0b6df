"""granite-34b [dense] — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,           # MQA
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=1e4,
    act="gelu",             # granite code models use GELU MLP
    source="arXiv:2405.04324 (Granite Code Models)",
)
