"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    ffn_type="relu2",            # squared-ReLU (Primer), per the paper
    rope_style="standard",
    norm_type="layernorm",       # nemotron uses LN with zero-centered gamma
)
