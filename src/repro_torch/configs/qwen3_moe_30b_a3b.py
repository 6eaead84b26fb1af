"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, QK-norm
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                    # per-expert width
    vocab_size=151936,
    ffn_type="swiglu",
    rope_style="standard",
    rope_base=1000000.0,
    qk_norm=True,                # qwen3 RMS-norms q and k per head
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                  shared_experts=0, capacity_factor=1.25),
    norm_type="rmsnorm",
)
