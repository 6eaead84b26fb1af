"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # no FFN: the mamba block is the layer
    vocab_size=50280,
    ffn_type="none",
    rope_style="none",
    attention_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, ngroups=1,
                  chunk=256),
    norm_type="rmsnorm",
    tie_embeddings=True,
    subquadratic=True,           # long_500k applies (constant state)
)
