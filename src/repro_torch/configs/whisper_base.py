"""whisper-base [audio] — enc-dec transformer backbone; conv frontend STUB
(precomputed frame embeddings) [arXiv:2212.04356].

6L here means 6 encoder + 6 decoder layers (whisper-base layout)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,              # kv=8: multi-head attention
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    ffn_type="gelu",
    rope_style="none",           # sinusoidal enc / learned dec positions
    learned_positions=True,
    norm_type="layernorm",
    frontend="audio_stub",
    max_position=1 << 16,
)
