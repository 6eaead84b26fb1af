"""starcoder2-3b [dense] — GQA kv=2, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    ffn_type="gelu",
    rope_style="standard",
    rope_base=100000.0,          # starcoder2 long-context base
    norm_type="layernorm",
)
