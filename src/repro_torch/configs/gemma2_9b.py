"""gemma2-9b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    ffn_type="geglu",
    rope_style="standard",
    attention_pattern=("local", "global"),   # 1:1 alternation, local first
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    norm_type="rmsnorm",
)
