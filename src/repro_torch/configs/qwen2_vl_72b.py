"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision frontend is a stub; callers pass precomputed
patch embeddings as batch["embeds"]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    ffn_type="swiglu",
    rope_style="mrope",          # (t, h, w) 3-section rotary
    rope_base=1000000.0,
    norm_type="rmsnorm",
    frontend="vision_stub",
)
