"""Architecture configuration schema.

Every registry architecture is a frozen ``ArchConfig``; reduced smoke
variants come from ``ArchConfig.reduced()``.  The paper's binary
technique plugs in through ``quant`` (``core/quantize.py``).  The fields,
their defaults, ``reduced()`` and ``param_counts()`` are the reference's
(``src/repro/configs/base.py``), so a config here and one there describe
the same shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from repro_torch.core.quantize import QuantConfig


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0          # llama4 has 1 shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:                     # Mamba-2 / SSD (arXiv:2405.21060)
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    ngroups: int = 1
    chunk: int = 256
    a_init_range: tuple[float, float] = (1.0, 16.0)
    # True: one fused in_proj ([z|x|B|C|dt] in one matmul), as the paper.
    # False: five separate projections and a split conv.
    fused_proj: bool = True


@dataclass(frozen=True)
class RGLRUConfig:                   # Griffin / RecurrentGemma (2402.19427)
    lru_width: int = 0               # 0 -> d_model
    conv_width: int = 4
    c_exponent: float = 8.0          # a = exp(-c * softplus(Λ) * r)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|ssm|moe|vlm|audio|hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attention_pattern: tuple[str, ...] = ("global",)   # cycled over layers
    window_size: int = 4096          # for 'local' layers
    rope_style: str = "standard"     # standard|partial|mrope|none
    rope_fraction: float = 1.0
    rope_base: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    learned_positions: bool = False  # whisper decoder
    max_position: int = 1 << 20

    # ffn
    ffn_type: str = "swiglu"         # swiglu|geglu|gelu|relu2|silu|none
    norm_type: str = "rmsnorm"

    # family extras
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    encoder_layers: int = 0          # >0 -> encoder-decoder (whisper)
    frontend: str | None = None      # 'audio_stub' | 'vision_stub'

    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    quant: QuantConfig = field(default_factory=QuantConfig)
    # KV-cache storage: 'bf16' | 'int8' (per-(token, head) absmax scale)
    kv_cache_dtype: str = "bf16"
    subquadratic: bool = False

    @property
    def pattern_period(self) -> int:
        return len(self.attention_pattern)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_kind(self, i: int) -> str:
        return self.attention_pattern[i % self.pattern_period]

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family and wiring, tiny dims."""
        changes: dict = dict(
            num_layers=max(2 * self.pattern_period, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            window_size=8,
            max_position=4096,
        )
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        if self.moe:
            changes["moe"] = replace(self.moe, num_experts=4,
                                     top_k=min(self.moe.top_k, 2),
                                     d_ff_expert=32)
        if self.ssm:
            changes["ssm"] = replace(self.ssm, d_state=16, head_dim=8,
                                     chunk=8)
        if self.rglru:
            changes["rglru"] = replace(self.rglru, lru_width=64)
        return replace(self, **changes)

    # ---- parameter counting (the dry run's FLOPs, ``should_fsdp``) -------
    def param_counts(self) -> dict[str, float]:
        """{"total", "active", "body_total", "body_active"}: parameters
        of the whole model and of the layer stack alone, "active" counting
        only the experts a token runs through; the reference's formula,
        value for value."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hq, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn_p = d * hd * (hq + 2 * hkv) + hq * hd * d
        if self.ffn_type in ("swiglu", "geglu"):
            ffn_p = 3 * d * f
        elif self.ffn_type == "none":
            ffn_p = 0
        else:
            ffn_p = 2 * d * f
        n_attn_layers = sum(1 for i in range(L)
                            if self.layer_kind(i) in ("global", "local"))
        n_rec_layers = L - n_attn_layers
        if self.ssm:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            ssm_p = (d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)
                     + d_in * d)
            total = active = L * ssm_p
        elif self.rglru:
            w = self.rglru.lru_width or d
            rec_p = 2 * d * w + w * d + 2 * w * w  # gates + in/out proj
            total = active = (n_attn_layers * (attn_p + ffn_p)
                              + n_rec_layers * (rec_p + ffn_p))
        elif self.moe:
            m = self.moe
            if self.ffn_type in ("swiglu", "geglu"):
                e_p = 3 * d * m.d_ff_expert
            else:
                e_p = 2 * d * m.d_ff_expert
            router_p = d * m.num_experts
            total = L * (attn_p + router_p
                         + (m.num_experts + m.shared_experts) * e_p)
            active = L * (attn_p + router_p
                          + (m.top_k + m.shared_experts) * e_p)
        else:
            total = active = L * (attn_p + ffn_p)
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_p + ffn_p)
            cross = L * (d * hd * (hq + 2 * hkv) + hq * hd * d)
            total += enc + cross
            active += enc + cross
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return {"total": float(total + emb), "active": float(active + emb),
                "body_total": float(total), "body_active": float(active)}


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry run: ``seq_len`` x ``global_batch``
    through the step of ``kind`` ('train' | 'prefill' | 'decode')."""
    name: str
    seq_len: int
    global_batch: int
    kind: str
