"""The launch cost model's types: one kernel launch's grid, threads a
block and dynamic shared memory as named terms, and the card's budget.

Each kernel module computes its own launch's estimate from its
launcher's arithmetic in ``csrc/`` (``bitpack.bitpack_estimate``,
``fused_epilogue.bn_sign_pack_estimate``, ``binary_matmul.gemm_estimate``
and ``dense_stack_estimate``, ``binary_conv.conv_estimate`` and
``bitplane_estimate``, ``binary_attention.attention_estimate``).  The two
launchers whose shared memory grows with the shape, K1's band search and
K6's activation buffers, refuse a launch that cannot fit a block with
:class:`SmemBudgetError` before launching; the other kernels' shared
memory is fixed and fits.  ``analysis.smem`` reads the same estimates
for the trace, the report and the card's query entries.
"""
from __future__ import annotations

import dataclasses

# An H100 block's opt-in shared memory (cudaDevAttrMaxSharedMemoryPerBlock-
# Optin) and an SM's registers.
SMEM_BUDGET = 232_448
REGS_PER_SM = 65_536
MAX_THREADS = 1024

# csrc/b1_mma.cuh, shared by K4, K3/K7 and K8: words of K a stage, the
# padded row stride of a stage in words, threads a block
BK, LDS, MMA_THREADS = 32, 36, 128
# csrc/common.cuh: the warp-per-word kernels' blocks
BLOCK_THREADS, WARPS_PER_BLOCK = 256, 8


@dataclasses.dataclass(frozen=True)
class SmemTerm:
    """One block's share of dynamic shared memory, in bytes."""
    name: str
    bytes: int


@dataclasses.dataclass(frozen=True)
class LaunchEstimate:
    """One launch: kernel, route, grid, threads a block, the dynamic
    shared memory as terms, the arguments of its launcher's query entry
    (library, entry, ints) and, on the card, the registers a thread and
    the static shared memory of the kernel instance."""
    kernel: str
    route: str
    grid: tuple[int, int, int]
    threads: int
    terms: tuple[SmemTerm, ...]
    query: tuple
    registers: int | None = None
    static_smem: int | None = None

    @property
    def dynamic(self) -> int:
        return sum(t.bytes for t in self.terms)

    @property
    def total(self) -> int:
        """Shared memory a block: dynamic, plus static where known."""
        return self.dynamic + (self.static_smem or 0)

    def fits(self, budget: int = SMEM_BUDGET) -> bool:
        regs_ok = (self.registers is None
                   or self.registers * self.threads <= REGS_PER_SM)
        return (self.total <= budget and self.threads <= MAX_THREADS
                and regs_ok)

    def breakdown(self) -> str:
        lines = [f"{self.kernel} ({self.route}) grid={self.grid} "
                 f"threads={self.threads}: {self.total} B shared memory a "
                 f"block"]
        lines += [f"  {t.name}: {t.bytes} B"
                  for t in sorted(self.terms, key=lambda t: -t.bytes)]
        if self.static_smem is not None:
            lines.append(f"  static: {self.static_smem} B; registers "
                         f"{self.registers} a thread")
        return "\n".join(lines)

    def to_json(self) -> dict:
        """The ``smem/*`` report cells' form (card-independent: no
        registers or static shared memory)."""
        return {"kernel": self.kernel, "route": self.route,
                "grid": list(self.grid), "threads": self.threads,
                "bytes": self.dynamic, "fits": self.fits(),
                "terms": {t.name: t.bytes for t in self.terms}}


class SmemBudgetError(ValueError):
    """A launch's shared memory (or threads) exceeds what a block can
    have on the card; ``detail`` is the launcher's own account."""

    def __init__(self, estimate: LaunchEstimate, budget: int = SMEM_BUDGET,
                 detail: str = ""):
        self.estimate = estimate
        self.budget = budget
        super().__init__(
            (f"{detail}\n" if detail else "")
            + f"launch would need {estimate.total} B of shared memory a "
            f"block, over the card's {budget} B (or more than "
            f"{MAX_THREADS} threads):\n{estimate.breakdown()}")


def preflight(estimate: LaunchEstimate,
              budget: int = SMEM_BUDGET) -> LaunchEstimate:
    """Raise :class:`SmemBudgetError` where ``estimate`` does not fit a
    block; return it otherwise."""
    if not estimate.fits(budget):
        raise SmemBudgetError(estimate, budget)
    return estimate


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round16(x: int) -> int:
    return (x + 15) & ~15


def blocks_for_warps(warps: int) -> int:
    """The grid of a warp-per-word kernel: WARPS_PER_BLOCK warps a block."""
    return ceil_div(warps, WARPS_PER_BLOCK)


def mma_ring(stages: int, bm: int, bn: int) -> tuple[SmemTerm, ...]:
    """A 1-bit MMA kernel's operand ring: ``stages`` stages of (bm + bn)
    rows of LDS words (csrc/b1_mma.cuh)."""
    return (SmemTerm("a_ring", stages * bm * LDS * 4),
            SmemTerm("b_ring", stages * bn * LDS * 4))
