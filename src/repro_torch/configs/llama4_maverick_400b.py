"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + 1 shared expert,
early fusion [hf:meta-llama/Llama-4]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,                   # per-expert width
    vocab_size=202048,
    ffn_type="swiglu",
    rope_style="standard",
    rope_base=500000.0,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  shared_experts=1, capacity_factor=1.25),
    norm_type="rmsnorm",
)
