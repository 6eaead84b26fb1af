"""Backend dispatchers for the packed kernels.

Shared argument semantics (every dispatcher in this module):

* ``backend``: ``'cuda'`` (the hand-written kernels), ``'torch'`` (the
  plain PyTorch versions in ``ref.py``, on whatever device the tensors
  are) or ``'auto'`` (``'cuda'`` for a CUDA tensor, ``'torch'`` for a CPU
  tensor).  ``'cuda'`` on a CPU tensor raises, and any other string
  raises ``ValueError`` (see :func:`_resolve`).  Nothing falls back from
  one backend to the other when a build or a launch fails.
* Packed words are ``torch.int32`` tensors with the bit pattern of the
  reference's ``uint32`` words.  The launch geometry stays inside the
  kernel wrappers; there are no block knobs.

On the ``'cuda'`` route each launch calls its kernel's CUDA body
(``kernels.library``: the wrapper on the op's arguments) directly; while
a dispatch mode is active (a trace: ``analysis.graph``), or on a tensor
subclass, it goes through the kernel's torch op
(``torch.ops.repro_torch.<kernel>``) instead, so the mode sees every
launch as one op.  A launch whose shared memory cannot fit a block
raises ``kernels.smem.SmemBudgetError`` before anything launches: K1's
and K6's launchers refuse it (the other kernels' shared memory is fixed
and fits), and a trace refuses every launch whose estimate does not fit.
"""
from __future__ import annotations

import torch

from repro_torch import telemetry
from repro_torch.kernels import binary_conv as _bconv
from repro_torch.kernels import binary_matmul as _bmm
from repro_torch.kernels import library as _lib
from repro_torch.kernels import ref as _ref

# Every kernel wrapper of the package by kernel name; each keeps an
# integer ``launches`` count of its own kernel launches.
KERNELS = {name: spec.wrapper for name, spec in _lib.SPECS.items()}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _resolve(backend: str, x: torch.Tensor) -> str:
    """Single point of backend resolution for every dispatcher."""
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda":
        if not x.is_cuda:
            raise ValueError(f"backend 'cuda' needs CUDA tensors, got a "
                             f"tensor on {x.device}")
        return backend
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    return backend


# How many dispatch modes (``TorchDispatchMode``, ``FakeTensorMode``) are
# active: one C call, cheap enough for every launch.
_dispatch_modes = torch._C._len_torch_dispatch_stack


def _launch(kernel: str, *args) -> torch.Tensor:
    """One launch of ``kernel`` on its op's ``args``: the CUDA body called
    directly, or the op while a dispatch mode is active or ``args[0]`` is
    a tensor subclass (a fake tensor)."""
    if _dispatch_modes() or type(args[0]) is not torch.Tensor:
        return _lib.CALLS[kernel](*args)
    return _lib.BODIES[kernel](*args)


def dispatch_batch(m: int, kw_words: int) -> str:
    """The route of a flush of ``m`` rows over dense layers of at most
    ``kw_words`` packed words of K: ``'gemv'`` where K4 takes its XOR +
    POPC kernel (``binary_matmul.gemm_route`` gives ``ROUTE_SMALL``, that
    is ``m <= binary_matmul.SMALL_M_MAX``, the crossover measured on the
    H100), else ``'gemm'`` (the 1-bit tensor-core kernel).  K4's small
    kernel takes any K, so ``kw_words`` only has to be positive.

    The serving layer's one routing rule (``train.serve``: the route of
    each ``FlushRecord``, ``route_for``, the ``serve.route.*`` counters).
    Raises ``ValueError`` if ``m`` or ``kw_words`` is not positive.  Every
    decision bumps ``ops.dispatch.gemv`` / ``ops.dispatch.gemm`` on the
    process-wide registry (``telemetry.default()``).
    """
    if m < 1 or kw_words < 1:
        raise ValueError(f"dispatch_batch needs positive (m, kw_words), got "
                         f"({m}, {kw_words})")
    route = "gemv" if m <= _bmm.SMALL_M_MAX else "gemm"
    telemetry.default().metrics.counter(f"ops.dispatch.{route}").inc()
    return route


def _as_float32(x: torch.Tensor) -> torch.Tensor:
    """The bit-pack kernel's float32 input, with the sign of every element
    of ``x`` kept.  A cast keeps it for every real dtype but float64,
    whose tiny negatives would round to -0.0 (bit 1), so float64 goes
    through ±1 first (NaN -> -1, bit 0, as ``x >= 0`` says)."""
    if x.dtype == torch.float64:
        return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
    return x.to(torch.float32)


def bitpack(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """Sign-binarize + pack along the last axis: (..., K) real ->
    (..., ceil(K/32)) words, bit = (x >= 0), LSB-first, zero-bit tail
    (-0.0 packs as 1 and NaN as 0).  The kernel takes float32; any other
    real dtype is converted first, its signs kept."""
    if _resolve(backend, x) == "torch":
        return _ref.bitpack_ref(x)
    x2 = _as_float32(x).reshape(-1, x.shape[-1]).contiguous()
    out = _launch("bitpack", x2)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def binary_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int | None = None,
                     attn_softcap: float | None = None, q_offset: int = 0,
                     backend: str = "auto") -> torch.Tensor:
    """Flash-style binary attention on real operands: q (B, Sq, Hq, D), k
    (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv) -> (B, Sq, Hq, Dv) float32.

    Q and K are sign-binarized; every score is (D - 2 * popcount) * D^-1/2,
    soft-capped by ``attn_softcap`` before masking; ``causal`` masks qpos <
    kpos (``q_offset`` aligns decode queries), ``window`` masks qpos - kpos
    >= window; the softmax is exact on the plain version and online in the
    kernel.  ``Hq % Hkv == 0`` groups query heads over KV heads.  On the
    card, q and k are packed along head_dim by :func:`bitpack` (two
    launches), then the attention kernel runs (one launch).  ``window``
    must be a positive int on every backend.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int, got {window!r}")
    if _resolve(backend, q) == "torch":
        return _ref.binary_attention_ref(q, k, v, causal=causal,
                                         window=window,
                                         attn_softcap=attn_softcap,
                                         q_offset=q_offset)
    return _launch("binary_attention", bitpack(q, backend=backend),
                   bitpack(k, backend=backend),
                   v.to(torch.float32).contiguous(), q.shape[-1], causal,
                   window, attn_softcap, q_offset)


def binary_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  backend: str = "auto") -> torch.Tensor:
    """Binary GEMM on real operands: (M, K) x (N, K) -> (M, N) int32 =
    sign(a) . sign(b)^T.  Both operands are packed through
    :func:`bitpack`, then contracted by :func:`binary_matmul_packed`."""
    return binary_matmul_packed(bitpack(a, backend=backend),
                                bitpack(b, backend=backend),
                                k_true=a.shape[-1], backend=backend)


def binary_matmul_packed(a_packed: torch.Tensor, b_packed: torch.Tensor, *,
                         k_true: int, backend: str = "auto") -> torch.Tensor:
    """Binary GEMM on pre-packed operands: (M, Kw) x (N, Kw) -> (M, N)
    int32; ``k_true`` is the logical K before packing."""
    if _resolve(backend, a_packed) == "cuda":
        return _launch("xnor_gemm", a_packed, b_packed, k_true)
    return _ref.binary_matmul_packed_ref(a_packed, b_packed, k_true)


def binary_matmul_bn_sign_packed(a_packed: torch.Tensor,
                                 b_packed: torch.Tensor, tau: torch.Tensor,
                                 flip: torch.Tensor, *, k_true: int,
                                 backend: str = "auto") -> torch.Tensor:
    """Fused packed GEMM + BN-sign fold + re-bitpack: (M, ceil(N/32))
    words, bit-identical to ``bn_sign_pack(binary_matmul_packed(...))``."""
    if _resolve(backend, a_packed) == "cuda":
        return _launch("xnor_gemm_bn_sign", a_packed, b_packed, tau, flip,
                       k_true)
    return _ref.binary_matmul_bn_sign_packed_ref(a_packed, b_packed, tau,
                                                 flip, k_true)


def binary_dense_stack_packed(stages: list, x_packed: torch.Tensor, *,
                              backend: str = "auto",
                              resident: bool | None = None) -> torch.Tensor:
    """A chain of hidden dense layers, each GEMM + BN-sign + re-bitpack:
    (M, Kw_0) words -> (M, ceil(N_last/32)) words, bit-identical to
    chaining :func:`binary_matmul_bn_sign_packed`.

    ``stages``: list of ``{"w_packed", "k_true", "tau", "flip"}``.  An
    empty list is the identity.  On the card, ``resident=None`` asks the
    shape rule ``binary_matmul.dense_stack_fits`` whether the stack runs
    as one launch (K6); ``True`` forces K6 and ``False`` one fused K4
    launch per layer.  The plain version serves every value of
    ``resident`` alike.
    """
    route = _resolve(backend, x_packed)
    if not stages:
        return x_packed
    if route == "torch":
        return _ref.binary_dense_stack_packed_ref(stages, x_packed)
    weights = [s["w_packed"] for s in stages]
    if resident is None:
        resident = _bmm.dense_stack_fits(weights)
    if resident:
        return _launch("dense_stack", x_packed.contiguous(),
                       [*weights, *(s["tau"] for s in stages),
                        *(s["flip"] for s in stages)],
                       [s["k_true"] for s in stages])
    h = x_packed.contiguous()
    for s in stages:
        h = _launch("xnor_gemm_bn_sign", h, s["w_packed"], s["tau"],
                    s["flip"], s["k_true"])
    return h


def bn_sign_pack(x: torch.Tensor, tau: torch.Tensor, flip: torch.Tensor, *,
                 backend: str = "auto") -> torch.Tensor:
    """Fused sign(BN(x)) + bit-pack along the last axis: (..., C) int32 ->
    (..., ceil(C/32)) words."""
    if _resolve(backend, x) == "torch":
        return _ref.bn_sign_pack_ref(x, tau, flip)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _launch("bn_sign_pack", x2, tau, flip)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _conv_geom(plan: dict) -> dict:
    return dict(kh=plan["kh"], kw=plan["kw"], stride=plan["stride"],
                pads=plan["pads"], c_out=plan["c_out"],
                k_true=plan["k_true"])


def binary_conv2d_packed(plan: dict, x_packed: torch.Tensor, *,
                         backend: str = "auto") -> torch.Tensor:
    """Packed conv on a ``make_conv_plan`` plan: (B, H, W, Cw) words ->
    (B, OH, OW, C_out) int32, the exact integer conv of the ±1 tensors
    with true zero padding (pad-as-(-1) + the C5 correction)."""
    if _resolve(backend, x_packed) == "torch":
        return _ref.binary_conv2d_packed_ref(
            x_packed, plan["w_packed"], plan["correction"],
            **_conv_geom(plan))
    return _launch("binary_conv", x_packed.contiguous(), plan["w_packed"],
                   plan["correction"], _lib.conv_geom(plan))


def binary_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  padding: str = "SAME",
                  backend: str = "auto") -> torch.Tensor:
    """Binary conv on real operands: ``x`` (B, H, W, C_in), ``w`` (C_out,
    KH, KW, C_in) -> (B, OH, OW, C_out) int32, the integer dots of
    conv(sign(x), sign(w)) with true zero padding.  The plan is built on
    the CPU and moved to ``x``'s device; ``x`` is channel-packed through
    :func:`bitpack`."""
    plan = _bconv.make_conv_plan(w, input_hw=tuple(x.shape[1:3]),
                                 stride=stride, padding=padding)
    plan = {k: v.to(x.device) if isinstance(v, torch.Tensor) else v
            for k, v in plan.items()}
    return binary_conv2d_packed(plan, bitpack(x, backend=backend),
                                backend=backend)


def binary_conv2d_bn_sign_packed(plan: dict, folded: dict,
                                 x_packed: torch.Tensor, *,
                                 backend: str = "auto") -> torch.Tensor:
    """Fused conv + BN-sign fold + re-bitpack on a ``make_conv_plan`` plan:
    (B, H, W, Cw) words -> (B, OH, OW, ceil(C_out/32)) words."""
    if _resolve(backend, x_packed) == "torch":
        return _ref.binary_conv2d_bn_sign_packed_ref(
            x_packed, plan["w_packed"], plan["correction"], folded["tau"],
            folded["flip"], **_conv_geom(plan))
    return _launch("conv_bn_sign", x_packed.contiguous(), plan["w_packed"],
                   plan["correction"], folded["tau"], folded["flip"],
                   _lib.conv_geom(plan))


def _bitplane_geom(plan: dict) -> dict:
    return dict(_conv_geom(plan), nbits=plan["nbits"])


def bitplane_conv2d_packed(plan: dict, x_uint8: torch.Tensor, *,
                           backend: str = "auto") -> torch.Tensor:
    """First-layer fixed-precision conv (paper C4) on a
    ``make_bitplane_conv_plan`` plan: raw (B, H, W, C_in) uint8 ->
    (B, OH, OW, C_out) int32.  On the card the conv is one kernel launch
    on the image itself: no bit plane is built.  The plain version packs
    the planes (``binarize.pack_bitplanes_uint8``) and convolves each."""
    if _resolve(backend, x_uint8) == "torch":
        return _ref.bitplane_conv2d_packed_ref(
            x_uint8, plan["w_packed"], plan["rowsum"], **_bitplane_geom(plan))
    return _launch("bitplane_conv", x_uint8.contiguous(), plan["w_packed"],
                   plan["rowsum"], [*_lib.conv_geom(plan), plan["nbits"]])


def bitplane_conv2d_bn_sign_packed(plan: dict, folded: dict,
                                   x_uint8: torch.Tensor, *,
                                   backend: str = "auto") -> torch.Tensor:
    """First-layer conv + BN-sign fold + re-bitpack on a
    ``make_bitplane_conv_plan`` plan and a folded BN (``tau``, ``flip``):
    raw (B, H, W, C_in) uint8 -> (B, OH, OW, ceil(C_out/32)) words,
    bit-identical to :func:`bn_sign_pack` of
    :func:`bitplane_conv2d_packed`.  On the card the conv with its
    epilogue is one kernel launch on the image itself."""
    if _resolve(backend, x_uint8) == "torch":
        return _ref.bitplane_conv2d_bn_sign_packed_ref(
            x_uint8, plan["w_packed"], plan["rowsum"], folded["tau"],
            folded["flip"], **_bitplane_geom(plan))
    return _launch("bitplane_conv_bn_sign", x_uint8.contiguous(),
                   plan["w_packed"], plan["rowsum"], folded["tau"],
                   folded["flip"], [*_lib.conv_geom(plan), plan["nbits"]])
