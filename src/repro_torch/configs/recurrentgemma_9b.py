"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent :
1 attention [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,               # 12 x (rec, rec, attn) + (rec, rec)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,              # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    ffn_type="geglu",
    rope_style="standard",
    attention_pattern=("rec", "rec", "local"),
    window_size=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, c_exponent=8.0),
    norm_type="rmsnorm",
    tie_embeddings=True,
    subquadratic=True,           # bounded window + constant LRU state
)
