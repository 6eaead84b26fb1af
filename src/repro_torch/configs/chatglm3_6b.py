"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2
[arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    ffn_type="swiglu",
    rope_style="partial",        # ChatGLM "2d" RoPE: rotate half of head_dim
    rope_fraction=0.5,
    norm_type="rmsnorm",
)
