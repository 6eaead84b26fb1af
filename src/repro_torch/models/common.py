"""Shared model components: norms, rotary embeddings, softcaps, embeddings
(the reference's ``models/common.py``).

Everything is functional: ``init_*(gen, ...) -> params`` draws from an
explicit ``torch.Generator`` on its device, and the apply functions are
pure.  Dtype policy: params are stored float32 and cast to the config's
activation dtype (bfloat16 by default) inside apply; norms accumulate in
float32.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.tree import leaves_with_path, tree_index, tree_map


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted
    (the dry run): the ``init_*`` functions given it make float32 tensors
    on the meta device, which hold no memory."""
    device = torch.device("meta")


def randn(gen: torch.Generator, shape, scale: float | None = None
          ) -> torch.Tensor:
    """Standard normal float32 from ``gen`` on its device, times
    ``scale``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x if scale is None else x * scale


def uniform(gen: torch.Generator, shape, lo: float, hi: float
            ) -> torch.Tensor:
    """Uniform float32 in [lo, hi) from ``gen`` on its device."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


def zeros(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(shape, device=gen.device, dtype=torch.float32)


def ones(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.ones(shape, device=gen.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(gen: torch.Generator, d: int) -> dict:
    return {"scale": zeros(gen, (d,))}                 # gemma-style (1+scale)


def apply_rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


def init_layernorm(gen: torch.Generator, d: int) -> dict:
    return {"scale": ones(gen, (d,)), "bias": zeros(gen, (d,))}


def apply_layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return y.to(x.dtype)


def init_norm(gen: torch.Generator, kind: str, d: int) -> dict:
    return init_rmsnorm(gen, d) if kind == "rmsnorm" \
        else init_layernorm(gen, d)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    return (apply_rmsnorm if kind == "rmsnorm" else apply_layernorm)(
        params, x)


# ---------------------------------------------------------------------------
# rotary position embeddings: standard, fractional (chatglm), M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(rot_dim: int, base: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for ``rot_dim`` rotary dims (rot_dim even)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (torch.tensor(base, dtype=torch.float32,
                               device=device) ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, base: float = 10000.0
               ) -> torch.Tensor:
    """Neox-style rotary embedding over the leading ``fraction`` of
    head_dim.  ``x``: (B, S, H, D); ``positions``: (B, S) integers.
    ``fraction=0.5`` is the ChatGLM "2d/partial" convention: only the first
    half of head_dim rotates, the rest passes through."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, base, device=x.device)                 # (rot/2,)
    ang = positions[..., None].to(torch.float32) * inv           # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    out = _rotate(x_rot, cos, sin).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass.to(x.dtype)], dim=-1)
    return out


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, *,
                sections: tuple[int, int, int] = (16, 24, 24),
                base: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency dims are split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  ``positions_3d``: (3, B, S).  For text all three streams are
    the sequence index, which makes it standard RoPE."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not cover {half} dims")
    inv = rope_freqs(d, base, device=x.device)                   # (half,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions_3d.to(torch.float32)                         # (3, B, S)
    ang = torch.movedim(pos[sec], 0, -1) * inv                   # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin).to(x.dtype)


def sinusoidal_positions(max_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (max_len, d)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (torch.tensor(10000.0, device=device) ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# sequence helpers
# ---------------------------------------------------------------------------

def pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` (B, S, ...) zero-padded along axis 1 to ``n`` positions."""
    if t.shape[1] > n:
        raise ValueError(f"a sequence of {t.shape[1]} does not fit {n}")
    if t.shape[1] == n:
        return t
    pad = torch.zeros((t.shape[0], n - t.shape[1], *t.shape[2:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  init_state: torch.Tensor | None = None):
    """Causal depthwise conv along S.  x: (B, S, C); w: (K, C); the taps
    summed in order.  Returns (y, final_state), final_state the last K-1
    inputs (the decode state)."""
    k = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((x.shape[0], k - 1, x.shape[-1]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([init_state, x], dim=1)
    n = x.shape[1]
    y = xp[:, 0:n, :] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + n, :] * w[i]
    return y + b, xp[:, -(k - 1):, :]


# ---------------------------------------------------------------------------
# softcap, embeddings, dense
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"table": randn(gen, (vocab, d), 0.02)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16
          ) -> torch.Tensor:
    """Rows of the table in ``dtype`` (the rows are gathered, then cast:
    the same values as casting the table first).  ``params`` may be a
    :class:`Parallel` whose ``trees[j]["table"]`` is position j's slice
    of the vocabulary, in vocabulary order (the sharded train step,
    ``distributed/fsdp.py``): :func:`embed_parallel`."""
    if isinstance(params, Parallel):
        return embed_parallel(params, tokens, dtype)
    table = params["table"]
    return table[tokens.to(device=table.device, dtype=torch.int64)].to(dtype)


def embed_parallel(par, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The lookup over the vocabulary slices of ``par``'s positions:
    position j looks up the tokens that fall in its slice and writes zero
    rows for the rest, and the positions' rows are summed on ``home`` in
    ``dtype`` itself (``par.reduce(..., wide=False)``).  Exactly one
    position holds a non-zero row for each token, so the sum is exact in
    any dtype, and at bfloat16 it moves half float32's bytes.  The
    backward gives each position the rows' gradient, which the lookup
    adds into its own slice's rows only (zero for the tokens it does not
    hold)."""
    parts, lo = [], 0
    for t, dev in zip(par.trees, par.devices):
        table = t["table"]
        n = table.shape[0]
        tok = tokens.to(device=dev, dtype=torch.int64)
        own = ((tok >= lo) & (tok < lo + n))[..., None]
        rows = table[(tok - lo).clamp(0, n - 1)].to(dtype)
        parts.append(torch.where(own, rows, torch.zeros(
            (), dtype=dtype, device=dev)))
        lo += n
    return par.reduce(parts, wide=False)


def embed_traffic(tokens: int, d: int, dtype) -> list:
    """The traffic entries (:class:`Parallel`) of one
    :func:`embed_parallel` of ``tokens`` ids into ``d``-wide rows of
    ``dtype``: the sum of the positions' rows."""
    return [("reduce", tokens * d, torch.empty((), dtype=dtype
                                               ).element_size())]


def unembed(params: dict, x: torch.Tensor, dtype=torch.bfloat16
            ) -> torch.Tensor:
    return torch.matmul(x, params["table"].to(dtype).T)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": randn(gen, (d_in, d_out), scale)}


def dense(params: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    dtype = dtype or x.dtype
    return torch.matmul(x, params["w"].to(dtype))


# ---------------------------------------------------------------------------
# layers stacked over depth, rematerialization
# ---------------------------------------------------------------------------

class Deferred:
    """A leaf of a layer's params that stands for a tensor made when the
    layer runs (a weight held in slices, say, and gathered by
    :meth:`value`).  :func:`remat` makes the Deferred leaves of its
    call's arguments inside the call, so the backward's recompute makes
    them again.  ``full_recompute``: the recompute must run the whole
    call, not stop once it has remade what the backward reads (a
    :class:`Parallel` block counts the traffic of every pass)."""
    requires_grad = False
    full_recompute = False

    def value(self) -> torch.Tensor:
        raise NotImplementedError


class Parallel:
    """A block's params split over the model positions of one data slice
    (tensor parallelism; made by ``distributed/fsdp.py``).  ``trees[j]``
    is position ``j``'s params tree: its slices of the leaves split over
    ``model``, every other leaf whole and the same tensor at every
    position; ``devices[j]`` its device; ``home`` the device of the data
    slice's activations.  The block functions (``attention_forward``,
    ``apply_ffn``, ``apply_moe``, ``rglru_block_forward``) take one in a
    params dict's place, run each position on its slice and combine the
    positions through the three collectives below, which count their
    traffic.  The vocabulary-parallel embedding (:func:`embed`) and loss
    (``models/model.py::loss_fn``) take one in the embedding's or the
    head's node's place, each position's tree holding its vocabulary
    slice.

    Each block module reckons one call's collectives from shapes
    (``parallel_traffic``): a list of (kind, elements, bytes an element)
    entries, one a collective, ``elements`` one position's tensor, so the
    positions other than the data slice's first move (|model| - 1) x
    elements x bytes.  Kinds: ``'reduce'`` (the forward's sums,
    :meth:`reduce`), ``'gather'`` (the forward's :meth:`gather`), and
    ``'grad'`` (the backward's sum of a :meth:`fan`'s partial
    gradients)."""
    trees: list
    devices: list
    home: torch.device

    @property
    def size(self) -> int:
        return len(self.trees)

    def sub(self, key: str) -> "Parallel":
        """The same positions over each tree's ``key`` subtree."""
        raise NotImplementedError

    def fan(self, x: torch.Tensor) -> list:
        """``x`` (on ``home``) at every position: the input of a
        column-parallel product; the backward sums the positions'
        gradients."""
        raise NotImplementedError

    def reduce(self, parts: list, wide: bool = True) -> torch.Tensor:
        """The sum over positions of ``parts`` (one a position) on
        ``home``, in float32 (float64 parts in float64): row-parallel
        partial products.  ``wide`` False: in the parts' own dtype, for
        sums with one non-zero term an element (exact in any dtype)."""
        raise NotImplementedError

    def gather(self, parts: list, dim: int = -1) -> torch.Tensor:
        """``parts`` (one a position) concatenated along ``dim`` on
        ``home``: an activation split over ``model``."""
        raise NotImplementedError


def fan_traffic(numel: int, dtype) -> list:
    """The traffic entry of one :meth:`Parallel.fan` of ``numel``
    elements of ``dtype``: its backward's sum of the positions' partial
    gradients, kept at least float32."""
    wide = torch.promote_types(dtype, torch.float32)
    return [("grad", numel, torch.empty((), dtype=wide).element_size())]


def materialize(tree):
    """``tree`` with every :class:`Deferred` leaf made; other leaves as
    they are."""
    return tree_map(lambda t: t.value() if isinstance(t, Deferred) else t,
                    tree)


def grad_views(src, dtype=None, groups: int | None = None) -> tuple:
    """(views, grads) for differentiating with respect to the tensors of
    ``src`` (a tree or one tensor): ``grads`` zeroed like ``src`` (its
    float32 leaves cast to ``dtype`` first, where given), ``views`` each
    tensor as an autograd leaf whose ``.grad`` is preset to its view of
    ``grads``, so that backward adds into ``grads`` in place (non-float
    leaves are plain detached tensors).  With ``groups``, ``views`` is a
    list of the ``groups`` axis-0 entries' trees (layers stacked over
    depth, read by :func:`layer_of`), each viewing its entry of
    ``grads``."""
    if dtype is not None:
        src = tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32
                       else p, src)
    grads = tree_map(torch.zeros_like, src)

    def views(s, g):
        return tree_map(_grad_leaf, s, g)
    if groups is None:
        return views(src, grads), grads
    return [views(tree_index(src, i), tree_index(grads, i))
            for i in range(groups)], grads


def _grad_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    t = p.detach()
    if t.is_floating_point():
        t.requires_grad_(True)
        t.grad = g
    return t


def layer_of(stacked, i: int):
    """Layer (or group) ``i`` of layers stacked over depth: a stacked tree
    is indexed along axis 0; a list already holds one tree per layer (the
    trainer differentiates with respect to per-layer views,
    ``train/trainer.py``)."""
    return stacked[i] if isinstance(stacked, list) else tree_index(stacked, i)


def remat(fn, on: bool):
    """``fn`` under non-reentrant ``torch.utils.checkpoint`` where ``on``,
    autograd is recording and a tensor among the call's arguments (a
    layer's params, :class:`Deferred` ones included, or its input)
    requires grad: its activations are recomputed in the backward pass
    instead of kept, as ``jax.checkpoint`` with the ``nothing_saveable``
    policy does.  Otherwise ``fn`` itself: a forward that nothing
    differentiates (serving) keeps nothing anyway.  The values do not
    change.  With ``on``, :class:`Deferred` leaves of the arguments are
    made inside the call (:func:`materialize`), again in the recompute;
    where one asks for ``full_recompute``, or a :class:`Parallel` is
    among the arguments (its collectives count every pass), the
    recompute runs the whole call (``torch.utils.checkpoint``'s early
    stop off)."""
    if not on:
        return fn

    def made(*args):
        return fn(*materialize(args))

    def run(*args):
        leaves = [t for _, t in leaves_with_path(args)]
        body = made if any(isinstance(t, Deferred) for t in leaves) else fn
        if torch.is_grad_enabled() and any(
                isinstance(t, (torch.Tensor, Deferred)) and t.requires_grad
                for t in leaves):
            whole = any(isinstance(t, Parallel) or (
                isinstance(t, Deferred) and t.full_recompute)
                for t in leaves)
            with set_checkpoint_early_stop(not whole):
                return checkpoint(body, *args, use_reentrant=False)
        return body(*args)
    return run
