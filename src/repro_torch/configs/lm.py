"""The configuration that the packed binary LM reads.

``LMSpec`` holds the fields of an ``ArchConfig`` (``configs/base.py``)
that the packed half of ``models/transformer.py`` uses, and nothing else.
``reduced()`` makes the same field changes as ``ArchConfig.reduced()``,
so a reduced spec and a reduced config have the same shapes, and
:meth:`LMSpec.from_arch` gives the packed LM any registry config.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LMSpec:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attention_pattern: tuple[str, ...] = ("global",)   # cycled over layers
    window_size: int = 4096          # for 'local' layers
    attn_softcap: float | None = None
    # The expert width of an MoE config, which the packed LM's FFN takes
    # when ``d_ff`` is 0 (``models.transformer._lm_d_ff``).
    moe_d_ff_expert: int | None = None

    @classmethod
    def from_arch(cls, cfg) -> "LMSpec":
        """The spec of an ``ArchConfig`` (this package's, or any object
        with its fields)."""
        return cls(
            name=cfg.name, num_layers=cfg.num_layers, d_model=cfg.d_model,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
            attention_pattern=tuple(cfg.attention_pattern),
            window_size=cfg.window_size, attn_softcap=cfg.attn_softcap,
            moe_d_ff_expert=(None if cfg.moe is None
                             else cfg.moe.d_ff_expert))

    @property
    def pattern_period(self) -> int:
        return len(self.attention_pattern)

    def layer_kind(self, i: int) -> str:
        return self.attention_pattern[i % self.pattern_period]

    def reduced(self) -> "LMSpec":
        """Smoke-test variant: same wiring, tiny dims."""
        return replace(
            self,
            num_layers=max(2 * self.pattern_period, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            window_size=8,
            moe_d_ff_expert=None if self.moe_d_ff_expert is None else 32,
        )


# gemma2-9b: local and global layers alternate (local first), a 4096-token
# window, attention logits soft-capped at 50 (arXiv:2408.00118).
GEMMA2_9B = LMSpec(
    name="gemma2-9b", num_layers=42, d_model=3584, num_heads=16,
    num_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
    attention_pattern=("local", "global"), window_size=4096,
    attn_softcap=50.0)

# starcoder2-3b: GQA with 2 KV heads, global attention (arXiv:2402.19173).
STARCODER2_3B = LMSpec(
    name="starcoder2-3b", num_layers=30, d_model=3072, num_heads=24,
    num_kv_heads=2, head_dim=128, d_ff=12288, vocab_size=49152)
