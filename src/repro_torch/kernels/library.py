"""Every kernel of the port as a torch op in namespace ``repro_torch``, and
one record of each kernel's facts.

:data:`SPECS` holds one :class:`KernelSpec` per kernel name (the keys of
``ops.KERNELS``): the op's schema, its CUDA body (the kernel's wrapper on
the op's arguments), its fake implementation (only the output's shape and
dtype), the launch's estimate from the op's arguments (grid, threads,
shared memory: the kernel modules' ``*_estimate``), the class of value it
makes (``analysis.packedness``), the reference's Pallas bodies it stands
for (``telemetry.probes``), its C library's entry table (the launcher's
query entry among them, ``analysis.smem.query_card``) and its wrapper,
whose ``launches`` counts its launches (``ops.KERNELS``).

Each op is defined with ``torch.library.Library("repro_torch", "DEF")``
(a ``Library``-defined op costs about a third of a ``custom_op`` call on
the host), implemented for the ``CUDA`` key by its body, passed through
at the autograd key (a kernel has no gradient), and given its fake
implementation.  So a forward run under ``FakeTensorMode``
(``analysis.graph``) traces every launch as one op without running a
kernel or touching a device.  ``kernels/ops.py``'s ``'cuda'`` route
calls the body directly, which costs the host no boxing, and goes
through the op only while a dispatch mode (a trace) is active.

Schemas take tensors, ints and int lists only: a plan's geometry is
flattened into ``geom`` (:func:`conv_geom`), the dense stack's per-stage
weights, taus and flips into one ``Tensor[]`` (weights first).

While :func:`record_launches` is active, each CUDA body appends its
kernel's name before it launches: the order of the real launches, which
``chip_smoke.py`` holds to a fake trace's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core import binarize as B
from repro_torch.kernels import binary_attention as _batt
from repro_torch.kernels import binary_conv as _bconv
from repro_torch.kernels import binary_matmul as _bmm
from repro_torch.kernels import bitpack as _bp
from repro_torch.kernels import fused_epilogue as _fe
from repro_torch.kernels import smem as S

NAMESPACE = "repro_torch"
# The tile rules' inputs where no card answers: an H100 SXM's 132 SMs, and
# how many K6 clusters of (16 rows, 16 blocks) and (16, 8) fit it at once
# (read by the occupancy query on the H100, PERF.md).
CARDLESS_SMS = 132
CARDLESS_STACK_CLUSTERS = {(16, 16): 7, (16, 8): 15}

_LIB = torch.library.Library(NAMESPACE, "DEF")
_recording: list | None = None


def conv_geom(plan: dict) -> list[int]:
    """A conv plan's geometry as the ops take it: kh, kw, stride, the pads
    top, bottom, left, right, out_h, out_w, c_out, k_true (and nbits for
    the bit-plane conv, appended by the caller)."""
    (pt, pb), (pl, pr) = plan["pads"]
    return [plan["kh"], plan["kw"], plan["stride"], pt, pb, pl, pr,
            *plan["out_hw"], plan["c_out"], plan["k_true"]]


def geom_kwargs(geom) -> dict:
    """:func:`conv_geom`'s list back as the conv wrappers' keywords."""
    kh, kw, stride, pt, pb, pl, pr, oh, ow, c_out, k_true = geom[:11]
    return dict(kh=kh, kw=kw, stride=stride, pads=((pt, pb), (pl, pr)),
                out_hw=(oh, ow), c_out=c_out, k_true=k_true)


@contextlib.contextmanager
def record_launches():
    """Collect, in order, the name of every kernel the CUDA bodies launch
    while active; yields the list."""
    global _recording
    outer, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = outer


# ---------------------------------------------------------------------------
# CUDA bodies: the kernels' wrappers on the ops' arguments
# ---------------------------------------------------------------------------

def _binary_attention(q_packed, k_packed, v, d_true, causal, window,
                      attn_softcap, q_offset):
    if _recording is not None:
        _recording.append("binary_attention")
    return _batt.binary_attention_packed(
        q_packed, k_packed, v, d_true=d_true, causal=causal, window=window,
        attn_softcap=attn_softcap, q_offset=q_offset)


def _binary_conv(x_packed, w_packed, correction, geom):
    if _recording is not None:
        _recording.append("binary_conv")
    return _bconv.binary_conv2d_packed(x_packed, w_packed, correction,
                                       **geom_kwargs(geom))


def _bitpack(x):
    if _recording is not None:
        _recording.append("bitpack")
    return _bp.bitpack(x)


def _bitplane_conv(x_uint8, w_packed, rowsum, geom):
    if _recording is not None:
        _recording.append("bitplane_conv")
    return _bconv.bitplane_conv2d_packed(x_uint8, w_packed, rowsum,
                                         nbits=geom[11], **geom_kwargs(geom))


def _bitplane_conv_bn_sign(x_uint8, w_packed, rowsum, tau, flip, geom):
    if _recording is not None:
        _recording.append("bitplane_conv_bn_sign")
    return _bconv.bitplane_conv2d_bn_sign_packed(
        x_uint8, w_packed, rowsum, tau, flip, nbits=geom[11],
        **geom_kwargs(geom))


def _bn_sign_pack(x, tau, flip):
    if _recording is not None:
        _recording.append("bn_sign_pack")
    return _fe.bn_sign_pack(x, tau, flip)


def _conv_bn_sign(x_packed, w_packed, correction, tau, flip, geom):
    if _recording is not None:
        _recording.append("conv_bn_sign")
    return _bconv.binary_conv2d_bn_sign_packed(
        x_packed, w_packed, correction, tau, flip, **geom_kwargs(geom))


def _dense_stack(x_packed, stages, k_trues):
    if _recording is not None:
        _recording.append("dense_stack")
    n = len(k_trues)
    return _bmm.binary_dense_stack_packed(
        x_packed, stages[:n], stages[n:2 * n], stages[2 * n:],
        k_trues=k_trues)


def _xnor_gemm(a_packed, b_packed, k_true):
    if _recording is not None:
        _recording.append("xnor_gemm")
    return _bmm.binary_matmul_packed(a_packed, b_packed, k_true=k_true)


def _xnor_gemm_bn_sign(a_packed, b_packed, tau, flip, k_true):
    if _recording is not None:
        _recording.append("xnor_gemm_bn_sign")
    return _bmm.binary_matmul_bn_sign_packed(a_packed, b_packed, tau, flip,
                                             k_true=k_true)


# ---------------------------------------------------------------------------
# Fake implementations: the output's shape and dtype, nothing launched
# ---------------------------------------------------------------------------

def _words(x, *lead, n):
    return x.new_empty((*lead, B.packed_width(n)), dtype=torch.int32)


def _fake_binary_attention(q_packed, k_packed, v, d_true, causal, window,
                           attn_softcap, q_offset):
    return v.new_empty((*q_packed.shape[:3], v.shape[-1]),
                       dtype=torch.float32)


def _fake_binary_conv(x_packed, w_packed, correction, geom):
    return x_packed.new_empty((x_packed.shape[0], geom[7], geom[8], geom[9]),
                              dtype=torch.int32)


def _fake_bitpack(x):
    return _words(x, x.shape[0], n=x.shape[1])


def _fake_bitplane_conv(x_uint8, w_packed, rowsum, geom):
    return x_uint8.new_empty((x_uint8.shape[0], geom[7], geom[8], geom[9]),
                             dtype=torch.int32)


def _fake_bitplane_conv_bn_sign(x_uint8, w_packed, rowsum, tau, flip, geom):
    return _words(x_uint8, x_uint8.shape[0], geom[7], geom[8], n=geom[9])


def _fake_bn_sign_pack(x, tau, flip):
    return _words(x, x.shape[0], n=x.shape[1])


def _fake_conv_bn_sign(x_packed, w_packed, correction, tau, flip, geom):
    return _words(x_packed, x_packed.shape[0], geom[7], geom[8], n=geom[9])


def _fake_dense_stack(x_packed, stages, k_trues):
    return _words(x_packed, x_packed.shape[0],
                  n=stages[len(k_trues) - 1].shape[0])


def _fake_xnor_gemm(a_packed, b_packed, k_true):
    return a_packed.new_empty((a_packed.shape[0], b_packed.shape[0]),
                              dtype=torch.int32)


def _fake_xnor_gemm_bn_sign(a_packed, b_packed, tau, flip, k_true):
    return _words(a_packed, a_packed.shape[0], n=b_packed.shape[0])



# ---------------------------------------------------------------------------
# Estimates: each launch's, from the op's own arguments
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> int:
    """The address of ``t``'s data, or for a fake tensor its offset into
    its storage (a fresh allocation is aligned past 16 bytes)."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


@functools.lru_cache(maxsize=None)
def sms_of(device: torch.device) -> int:
    """The SM count the tile rules take: the card's, else
    :data:`CARDLESS_SMS`."""
    if torch.cuda.is_available():
        return _bmm.sm_count(device)
    return CARDLESS_SMS


def stack_fit(device: torch.device, buf_words: int) -> dict:
    """K6's clusters that fit at once (``binary_matmul.stack_clusters``),
    else :data:`CARDLESS_STACK_CLUSTERS`."""
    if torch.cuda.is_available():
        return _bmm.stack_clusters(device, buf_words)
    return CARDLESS_STACK_CLUSTERS


def _est_bitpack(sms, x):
    m, k = x.shape
    return _bp.bitpack_estimate(m, k, _bp.packs_aligned(k, _ptr(x)))


def _est_bn_sign_pack(sms, x, tau, flip):
    m, c = x.shape
    return _fe.bn_sign_pack_estimate(m, c, _fe.bn_sign_aligned(c, _ptr(x)),
                                     sms or sms_of(x.device))


def _gemm(a, b, fused, sms):
    m, kw = a.shape
    vec16 = _bmm.rows_aligned16((_ptr(a), kw), (_ptr(b), kw))
    return _bmm.gemm_estimate(m, b.shape[0], kw, fused, vec16,
                              sms or sms_of(a.device))


def _est_xnor_gemm(sms, a, b, k_true):
    return _gemm(a, b, False, sms)


def _est_xnor_gemm_bn_sign(sms, a, b, tau, flip, k_true):
    return _gemm(a, b, True, sms)


def _conv(x, w, geom, fused, sms):
    bsz, _, _, cw = x.shape
    kh, kw, oh, ow, c_out = geom[0], geom[1], geom[7], geom[8], geom[9]
    vec16 = _bmm.rows_aligned16((_ptr(x), cw), (_ptr(w), kh * kw * cw))
    return _bconv.conv_estimate(bsz, oh, ow, c_out, fused, vec16,
                                sms or sms_of(x.device))


def _est_conv_bn_sign(sms, x, w, correction, tau, flip, geom):
    return _conv(x, w, geom, True, sms)


def _est_binary_conv(sms, x, w, correction, geom):
    return _conv(x, w, geom, False, sms)


def _bitplane(x_uint8, geom, fused):
    bsz, h, w, _ = x_uint8.shape
    kh, kw, stride, pt, _, pl = geom[:6]
    c_in = geom[10] // (kh * kw)
    return _bconv.bitplane_estimate(bsz, h, w, B.packed_width(c_in), c_in,
                                    geom[9], kh, kw, stride, pt, pl, geom[7],
                                    geom[8], geom[11], fused)


def _est_bitplane_conv(sms, x_uint8, w, rowsum, geom):
    return _bitplane(x_uint8, geom, False)


def _est_bitplane_conv_bn_sign(sms, x_uint8, w, rowsum, tau, flip, geom):
    return _bitplane(x_uint8, geom, True)


def _est_dense_stack(sms, x, stages, k_trues):
    m, kw0 = x.shape
    weights = stages[:len(k_trues)]
    buf_words = _bmm.stack_buffer_words(weights)
    rows, cluster = _bmm.stack_tile(m, stack_fit(x.device, buf_words))
    vec16 = _bmm.rows_aligned16((_ptr(x), kw0),
                                *((_ptr(w), w.shape[1]) for w in weights))
    return _bmm.dense_stack_estimate(m, rows, cluster, buf_words, vec16)


def _est_binary_attention(sms, q, k, v, d_true, causal, window,
                          attn_softcap, q_offset):
    b, sq, hq, dw = q.shape
    return _batt.attention_estimate(b, sq, hq, dw, v.shape[-1])


# ---------------------------------------------------------------------------
# One record a kernel
# ---------------------------------------------------------------------------

# What a kernel's output holds, for ``analysis.packedness``
WORDS, ACCUMULATOR, FLOAT = "words", "accumulator", "float"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel's facts (module docstring).  ``estimate(sms, *args)``
    gives the launch's ``smem.LaunchEstimate`` on the op's ``args`` at
    ``sms`` SMs (None: the device's).  ``reference``: the reference's
    Pallas bodies one launch stands for, or for K4 and K4-fused a dict by
    route ('small': the XOR + POPC kernel where the reference takes its
    GEMV, 'mma': the tensor cores where it takes its GEMM)."""
    schema: str
    wrapper: Callable
    body: Callable
    fake: Callable
    estimate: Callable
    makes: str
    reference: tuple | dict
    library: str
    entries: dict


SPECS = {
    "binary_attention": KernelSpec(
        "binary_attention(Tensor q_packed, Tensor k_packed, Tensor v, "
        "int d_true, bool causal, int? window, float? attn_softcap, "
        "int q_offset) -> Tensor",
        _batt.binary_attention_packed, _binary_attention,
        _fake_binary_attention, _est_binary_attention, FLOAT,
        ("_attention_kernel",), "binary_attention", _batt.ENTRIES),
    "binary_conv": KernelSpec(
        "binary_conv(Tensor x_packed, Tensor w_packed, Tensor correction, "
        "int[] geom) -> Tensor",
        _bconv.binary_conv2d_packed, _binary_conv, _fake_binary_conv,
        _est_binary_conv, ACCUMULATOR, ("_conv_kernel",), "conv_bn_sign",
        _bconv.CONV_ENTRIES),
    "bitpack": KernelSpec(
        "bitpack(Tensor x) -> Tensor",
        _bp.bitpack, _bitpack, _fake_bitpack, _est_bitpack, WORDS,
        ("_bitpack_kernel",), "bitpack", _bp.ENTRIES),
    "bitplane_conv": KernelSpec(
        "bitplane_conv(Tensor x_uint8, Tensor w_packed, Tensor rowsum, "
        "int[] geom) -> Tensor",
        _bconv.bitplane_conv2d_packed, _bitplane_conv, _fake_bitplane_conv,
        _est_bitplane_conv, ACCUMULATOR, ("_bitplane_conv_kernel",),
        "bitplane_conv", _bconv.BITPLANE_ENTRIES),
    # K1's body with K2's epilogue inside
    "bitplane_conv_bn_sign": KernelSpec(
        "bitplane_conv_bn_sign(Tensor x_uint8, Tensor w_packed, "
        "Tensor rowsum, Tensor tau, Tensor flip, int[] geom) -> Tensor",
        _bconv.bitplane_conv2d_bn_sign_packed, _bitplane_conv_bn_sign,
        _fake_bitplane_conv_bn_sign, _est_bitplane_conv_bn_sign, WORDS,
        ("_bitplane_conv_kernel", "_bn_sign_pack_kernel"), "bitplane_conv",
        _bconv.BITPLANE_ENTRIES),
    "bn_sign_pack": KernelSpec(
        "bn_sign_pack(Tensor x, Tensor tau, Tensor flip) -> Tensor",
        _fe.bn_sign_pack, _bn_sign_pack, _fake_bn_sign_pack,
        _est_bn_sign_pack, WORDS, ("_bn_sign_pack_kernel",), "bn_sign_pack",
        _fe.ENTRIES),
    "conv_bn_sign": KernelSpec(
        "conv_bn_sign(Tensor x_packed, Tensor w_packed, Tensor correction, "
        "Tensor tau, Tensor flip, int[] geom) -> Tensor",
        _bconv.binary_conv2d_bn_sign_packed, _conv_bn_sign,
        _fake_conv_bn_sign, _est_conv_bn_sign, WORDS,
        ("_conv_bn_sign_kernel",), "conv_bn_sign", _bconv.CONV_ENTRIES),
    "dense_stack": KernelSpec(
        "dense_stack(Tensor x_packed, Tensor[] stages, int[] k_trues) "
        "-> Tensor",
        _bmm.binary_dense_stack_packed, _dense_stack, _fake_dense_stack,
        _est_dense_stack, WORDS, ("_dense_stack_kernel",), "dense_stack",
        _bmm.STACK_ENTRIES),
    "xnor_gemm": KernelSpec(
        "xnor_gemm(Tensor a_packed, Tensor b_packed, int k_true) -> Tensor",
        _bmm.binary_matmul_packed, _xnor_gemm, _fake_xnor_gemm,
        _est_xnor_gemm, ACCUMULATOR,
        {"small": ("_gemv_kernel",), "mma": ("_gemm_kernel",)}, "xnor_gemm",
        _bmm.GEMM_ENTRIES),
    "xnor_gemm_bn_sign": KernelSpec(
        "xnor_gemm_bn_sign(Tensor a_packed, Tensor b_packed, Tensor tau, "
        "Tensor flip, int k_true) -> Tensor",
        _bmm.binary_matmul_bn_sign_packed, _xnor_gemm_bn_sign,
        _fake_xnor_gemm_bn_sign, _est_xnor_gemm_bn_sign, WORDS,
        {"small": ("_gemv_bn_sign_kernel",), "mma": ("_gemm_bn_sign_kernel",)},
        "xnor_gemm", _bmm.GEMM_ENTRIES),
}

for _name, _spec in SPECS.items():
    _LIB.define(_spec.schema)
    _LIB.impl(_name, _spec.body, "CUDA")
    # no gradient flows through a kernel: the dispatcher skips the
    # autograd key instead of running its not-implemented fallback
    _LIB.impl(_name, torch.library.fallthrough_kernel, "Autograd")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _spec.fake,
                                lib=_LIB)

# The ops' overloads by kernel name; calling the overload skips the
# packet's lookup.
OPS = {name: getattr(getattr(torch.ops, NAMESPACE), name).default
       for name in SPECS}
# Each overload's C++ callable: the op's dispatch without
# ``OpOverload.__call__``'s Python frame; and each CUDA body.  The
# dispatchers of ``kernels/ops.py`` launch through one or the other.
CALLS = {name: op._op for name, op in OPS.items()}
BODIES = {name: spec.body for name, spec in SPECS.items()}


def kernel_of(func) -> str | None:
    """The kernel name of one of these ops' overloads, else None."""
    if getattr(func, "namespace", None) != NAMESPACE:
        return None
    return func._schema.name.split("::", 1)[1]


def estimate_call(kernel: str, args: tuple,
                  sms: int | None = None) -> S.LaunchEstimate:
    """The estimate of one call of ``kernel``'s op on ``args``, its own
    arguments; ``sms`` the SM count the tile rules take (default
    :func:`sms_of` the device).  K6's tile takes the clusters that fit
    (:func:`stack_fit`) whatever ``sms``."""
    return SPECS[kernel].estimate(sms, *args)


def reference_bodies(kernel: str, route: str) -> tuple[str, ...]:
    """The reference bodies one launch of ``kernel`` on ``route`` stands
    for (:attr:`KernelSpec.reference`)."""
    bodies = SPECS[kernel].reference
    if isinstance(bodies, dict):
        return bodies["small" if route.startswith("small") else "mma"]
    return bodies
