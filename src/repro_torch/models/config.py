"""Model configuration system (a copy of ``repro.models.config``, which
the port may not import; pure Python, so the two stay identical).

One ``ModelConfig`` describes any of the six assigned architecture families
(dense / MoE / audio enc-dec / VLM / hybrid SSM+attn / pure SSM).  Every
assigned architecture in ``repro_torch.configs.<id>`` instantiates this dataclass
with the exact published hyperparameters, and ``reduced()`` derives the
smoke-test variant (<=2 layers, d_model<=512, <=4 experts) mandated for CPU
tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 => attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # ---- attention ----
    rope_theta: float = 1e4
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: Optional[int] = None   # ring-buffer window for long ctx
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    n_shared_experts: int = 0       # kimi-k2 style shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ---- SSM / hybrid ----
    ssm_state: int = 0              # mamba2 N
    ssm_head_dim: int = 64          # mamba2 P
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_every: int = 0             # hybrid: attention block every k layers

    # ---- encoder-decoder (whisper) ----
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0            # whisper: 1500 frames
    max_target_positions: int = 0   # learned positions (whisper: 448)

    # ---- modality frontend (STUB per mandate) ----
    modality: str = "text"          # text | audio | vision

    # ---- misc ----
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                # citation

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind for the decoder stack."""
        if self.arch_type == "ssm":
            return ["rwkv"] * self.n_layers
        if self.arch_type == "hybrid":
            k = max(self.attn_every, 1)
            return ["attn" if (i + 1) % k == 0 else "mamba"
                    for i in range(self.n_layers)]
        return ["attn"] * self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim if self.n_heads else 0
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        attn_counted = False
        for kind in self.layer_kinds():
            if kind == "attn":
                if self.arch_type == "hybrid" and attn_counted:
                    continue  # zamba: ONE shared attention block
                attn_counted = True
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += self._mlp_params()
                total += 2 * d  # norms
            elif kind == "mamba":
                di = self.ssm_expand * d
                nh = di // self.ssm_head_dim
                conv_dim = di + 2 * self.ssm_state * nh
                total += d * (2 * di + 2 * self.ssm_state * nh + nh)  # in_proj
                total += self.ssm_conv_width * conv_dim + conv_dim
                total += di * d  # out_proj
                total += 3 * nh  # A, D, dt_bias
                total += d
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o (time mix)
                total += 2 * d * self.d_ff + d * d  # channel mix approx
                total += 2 * d
        if self.is_encoder_decoder:
            # encoder layers + cross attention in decoder
            enc = self.n_encoder_layers * (
                4 * d * self.n_heads * hd + self._mlp_params() + 2 * d)
            cross = self.n_layers * (4 * d * self.n_heads * hd + d)
            total += enc + cross
        return int(total)

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.is_moe:
            per_expert = 3 * d * self.moe_d_ff
            dense = self.n_experts * per_expert
            dense += self.n_shared_experts * per_expert
            dense += d * self.n_experts  # router
            return dense
        n_mats = 3 if self.act == "silu" else 2
        return n_mats * d * self.d_ff

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        per_expert = 3 * d * self.moe_d_ff
        inactive = (self.n_experts - self.experts_per_token) * per_expert
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == "attn")
        return self.param_count() - n_moe_layers * inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        hd = 64
        n_heads = max(d // hd, 1) if self.n_heads else 0
        n_kv = max(min(self.n_kv_heads, n_heads), 1) if self.n_heads else 0
        mrope = None
        if self.mrope_sections:
            # rescale the t/h/w bands to the reduced head_dim
            old_half = sum(self.mrope_sections)
            ratio = (hd // 2) / old_half
            t, h_, w_ = (int(s * ratio) for s in self.mrope_sections)
            mrope = (hd // 2 - h_ - w_, h_, w_)
        return dataclasses.replace(
            self,
            mrope_sections=mrope,
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd if self.n_heads else None,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.is_moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            max_target_positions=(min(self.max_target_positions, 128)
                                  if self.max_target_positions else 0),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
