"""Mamba-2 block, SSD (state-space duality) chunked algorithm (the
reference's ``models/ssm.py``; Dao & Gu, arXiv:2405.21060):

  zxbcdt = in_proj(u)                         # [z | x | B | C | dt]
  x,B,C <- causal conv1d (width d_conv) + silu
  dt    <- softplus(dt + dt_bias);   A = -exp(A_log)   (per head)
  y     = SSD(x * dt, A * dt, B, C)  + D * x
  out   = out_proj( rmsnorm(y * silu(z)) )

The SSD scan runs chunk by chunk carrying the (B, H, P, N) inter-chunk
state; decode is the constant-memory recurrence.  The in/out projections
are quant-aware linears; the selective recurrence is not binarized.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import linear as LN


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return s, d_inner, nheads, conv_dim


def init_mamba2(gen: torch.Generator, cfg) -> dict:
    s, d_inner, nheads, conv_dim = _dims(cfg)
    d = cfg.d_model
    lo, hi = s.a_init_range
    a = torch.exp(C.uniform(gen, (nheads,), math.log(lo), math.log(hi)))
    p = {
        "A_log": torch.log(a),
        "D": C.ones(gen, (nheads,)),
        "dt_bias": C.zeros(gen, (nheads,)),
        "norm": C.init_rmsnorm(gen, d_inner),
        "out_proj": LN.init_linear(gen, d_inner, d),
    }
    gn = s.ngroups * s.d_state
    if s.fused_proj:
        p["in_proj"] = LN.init_linear(gen, d, 2 * d_inner + 2 * gn + nheads)
        p["conv_w"] = C.randn(gen, (s.d_conv, conv_dim), 0.1)
        p["conv_b"] = C.zeros(gen, (conv_dim,))
    else:
        # the split form carries distinct names, as in the reference
        p["out_proj_tp"] = p.pop("out_proj")
        p["norm_tp"] = p.pop("norm")
        p["z_proj"] = LN.init_linear(gen, d, d_inner)
        p["x_proj"] = LN.init_linear(gen, d, d_inner)
        p["b_proj"] = LN.init_linear(gen, d, gn)
        p["c_proj"] = LN.init_linear(gen, d, gn)
        p["dt_proj"] = LN.init_linear(gen, d, nheads)
        for name, width in (("x", d_inner), ("b", gn), ("c", gn)):
            p[f"conv_w_{name}"] = C.randn(gen, (s.d_conv, width), 0.1)
            p[f"conv_b_{name}"] = C.zeros(gen, (width,))
    return p


def _split_zxbcdt(cfg, zxbcdt: torch.Tensor):
    s, d_inner, nheads, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, nheads], dim=-1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L).  out[..., i, j] = sum_{k=j+1..i} a_k (i >= j), -inf
    above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """The SSD chunked scan.

    x: (B, S, H, P) inputs (already times dt); a: (B, S, H) log-decay per
    step (A * dt); b, c: (B, S, G, N) input and output projections.
    Returns (y (B, S, H, P), final_state (B, H, P, N)).
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    hpg = h // g

    def to_chunks(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, ac, bc, cc = map(to_chunks, (x, a, b, c))
    ac = torch.movedim(ac, -1, 2)                      # (B, nc, H, L)
    state = init_state if init_state is not None else torch.zeros(
        (bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        xl, al, bl, cl = xc[:, i], ac[:, i], bc[:, i], cc[:, i]
        a_cs = torch.cumsum(al, dim=-1)                # (B,H,L)
        Lm = torch.exp(_segsum(al))                    # (B,H,L,L)
        bl_h = torch.repeat_interleave(bl, hpg, dim=2)  # (B,L,H,N)
        cl_h = torch.repeat_interleave(cl, hpg, dim=2)
        x32 = xl.to(torch.float32)
        scores = torch.einsum("blhn,bshn->bhls", cl_h.to(torch.float32),
                              bl_h.to(torch.float32))
        y_diag = torch.einsum("bhls,bhls,bshp->blhp", scores, Lm, x32)
        decay_in = torch.exp(a_cs[..., -1:] - a_cs)    # (B,H,L)
        new_contrib = torch.einsum("blhn,bhl,blhp->bhpn", bl_h, decay_in,
                                   x32)
        chunk_decay = torch.exp(a_cs[..., -1])         # (B,H)
        decay_out = torch.exp(a_cs)                    # (B,H,L)
        y_off = torch.einsum("blhn,bhpn,bhl->blhp", cl_h, state, decay_out)
        state = state * chunk_decay[..., None, None] + new_contrib
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y, state


def _project_conv_full(params: dict, cfg, u: torch.Tensor,
                       init_cache: dict | None):
    """Input projections + causal conv, fused or split form.  Returns
    (z, x, b, c, dt, conv_caches)."""
    s, d_inner, nheads, conv_dim = _dims(cfg)
    dt_ = cfg.activation_dtype
    gn = s.ngroups * s.d_state
    if s.fused_proj:
        zxbcdt = LN.apply_linear(params["in_proj"], u, cfg.quant, dtype=dt_)
        z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
        conv_init = init_cache["conv"] if init_cache else None
        xbc, conv_state = C.causal_conv1d(
            xbc.to(torch.float32), params["conv_w"], params["conv_b"],
            conv_init)
        xbc = F.silu(xbc)
        x, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)
        return z, x, b, c, dt, {"conv": conv_state}
    z = LN.apply_linear(params["z_proj"], u, cfg.quant, dtype=dt_)
    dt = LN.apply_linear(params["dt_proj"], u, cfg.quant, dtype=dt_)
    caches, outs = {}, {}
    for name in ("x", "b", "c"):
        t = LN.apply_linear(params[f"{name}_proj"], u, cfg.quant, dtype=dt_)
        init = init_cache[f"conv_{name}"] if init_cache else None
        t, st = C.causal_conv1d(t.to(torch.float32),
                                params[f"conv_w_{name}"],
                                params[f"conv_b_{name}"], init)
        outs[name] = F.silu(t)
        caches[f"conv_{name}"] = st
    return z, outs["x"], outs["b"], outs["c"], dt, caches


def _out(params: dict, cfg, y: torch.Tensor, z: torch.Tensor):
    dt_ = cfg.activation_dtype
    y = y * F.silu(z.to(torch.float32))
    norm = params["norm"] if "norm" in params else params["norm_tp"]
    y = C.apply_rmsnorm(norm, y.to(dt_))
    proj = params["out_proj"] if "out_proj" in params \
        else params["out_proj_tp"]
    return LN.apply_linear(proj, y, cfg.quant, dtype=dt_)


def _scan(cfg, x, b, c, dt, dt_bias, a_log, d_skip, init_state=None):
    """The selective scan of ``x`` (B, S, H, P) over the heads of
    ``dt_bias``, ``a_log`` and ``d_skip`` (H,): dt (B, S, H) through
    softplus, the SSD scan on whole chunks (the sequence zero-padded),
    plus the skip.  Returns (y (B, S, H, P) float32, final state)."""
    s = cfg.ssm
    slen = x.shape[1]
    dt = F.softplus(dt.to(torch.float32) + dt_bias)
    a = -torch.exp(a_log)                              # (H,), negative
    pad = (-slen) % s.chunk
    if pad:
        x, b, c, dt = (C.pad_seq(t, slen + pad) for t in (x, b, c, dt))
    y, state = ssd_chunked(x * dt[..., None], a * dt, b, c, s.chunk,
                           init_state=init_state)
    y = y[:, :slen]
    x = x[:, :slen]
    return y + x.to(torch.float32) * d_skip[:, None], state


def heads_split(cfg, m: int) -> bool:
    """Whether the block splits over ``m`` model positions on whole
    units: the split form (the fused one interleaves five blocks on one
    axis), ``m`` dividing the heads, and each position's heads reading
    whole groups of B and C, or all one group (``m`` a multiple of the
    groups, or dividing them)."""
    s, _, nheads, _ = _dims(cfg)
    return (not s.fused_proj and nheads % m == 0
            and (s.ngroups % m == 0 or m % s.ngroups == 0))


def parallel_traffic(cfg, tokens: int, dtype) -> list:
    """The traffic entries (``common.Parallel``) of one tensor-parallel
    :func:`mamba2_forward` on ``tokens`` rows of ``dtype``: the input
    fanned out, B, C (float32) and dt fanned out, the norm's float32
    partial sums of squares summed and fanned back, the partial outputs
    of ``out_proj_tp`` summed."""
    s, _, nheads, _ = _dims(cfg)
    d = cfg.d_model
    gn = s.ngroups * s.d_state
    return (C.fan_traffic(tokens * d, dtype)
            + 2 * C.fan_traffic(tokens * gn, torch.float32)
            + C.fan_traffic(tokens * nheads, dtype)
            + [("reduce", tokens, 4)]
            + C.fan_traffic(tokens, torch.float32)
            + LN.row_parallel_traffic(cfg.quant, tokens * d, d))


def _forward_parallel(par, cfg, u: torch.Tensor) -> torch.Tensor:
    """The split form over the positions of ``par`` (a
    ``common.Parallel``, :func:`heads_split`): position j holds the
    columns of ``z_proj`` and ``x_proj``, the conv channels of x, the
    ``norm_tp`` scale and the rows of ``out_proj_tp`` of its heads.
    ``dt_proj``, ``b_proj``, ``c_proj``, the B/C convs, ``A_log``, ``D``
    and ``dt_bias`` are whole at every position (the rules replicate
    them over ``model``): B, C and dt are made once, at the first
    position (``home``) from its copy of the input, and fanned out; each
    position slices dt, ``A_log``, ``D`` and ``dt_bias`` to its heads and
    runs the SSD scan on them (the scan is per head).  The gated RMSNorm
    spans the whole d_inner: the positions' float32 sums of squares are
    summed over ``model`` and fanned back before each scales its
    channels.  ``out_proj_tp`` is row-parallel
    (``linear.apply_row_parallel``)."""
    s, d_inner, nheads, _ = _dims(cfg)
    dt_ = cfg.activation_dtype
    bsz, slen, _ = u.shape
    us = par.fan(u)
    whole = par.trees[0]
    dt = LN.apply_linear(whole["dt_proj"], us[0], cfg.quant, dtype=dt_,
                         column=True)
    bc = []
    for name in ("b", "c"):
        t = LN.apply_linear(whole[f"{name}_proj"], us[0], cfg.quant,
                            dtype=dt_, column=True)
        t, _ = C.causal_conv1d(t.to(torch.float32),
                               whole[f"conv_w_{name}"],
                               whole[f"conv_b_{name}"])
        bc.append(F.silu(t).reshape(bsz, slen, s.ngroups, s.d_state))
    bs, cs, dts = par.fan(bc[0]), par.fan(bc[1]), par.fan(dt)
    hl = nheads // par.size
    hpg = nheads // s.ngroups
    ys = []
    for j, (t, uj) in enumerate(zip(par.trees, us)):
        heads = slice(j * hl, (j + 1) * hl)
        groups = slice(j * hl // hpg, -(-(j + 1) * hl // hpg))
        z = LN.apply_linear(t["z_proj"], uj, cfg.quant, dtype=dt_,
                            column=True)
        x = LN.apply_linear(t["x_proj"], uj, cfg.quant, dtype=dt_,
                            column=True)
        x, _ = C.causal_conv1d(x.to(torch.float32), t["conv_w_x"],
                               t["conv_b_x"])
        x = F.silu(x).reshape(bsz, slen, hl, s.head_dim)
        y, _ = _scan(cfg, x, bs[j][:, :, groups], cs[j][:, :, groups],
                     dts[j][..., heads], t["dt_bias"][heads],
                     t["A_log"][heads], t["D"][heads])
        y = y.reshape(bsz, slen, hl * s.head_dim) * F.silu(
            z.to(torch.float32))
        ys.append(y.to(dt_).to(torch.float32))
    sq = par.fan(par.reduce([(y * y).sum(-1, keepdim=True) for y in ys]))
    outs = [(y * torch.rsqrt(q / d_inner + 1e-6)
             * (1.0 + t["norm_tp"]["scale"])).to(dt_)
            for y, q, t in zip(ys, sq, par.trees)]
    return LN.apply_row_parallel(par, [t["out_proj_tp"] for t in par.trees],
                                 outs, cfg.quant, dtype=dt_)


def mamba2_forward(params, cfg, u: torch.Tensor, *,
                   init_cache: dict | None = None,
                   return_cache: bool = False):
    """Full-sequence forward.  u: (B, S, D) -> (B, S, D).  ``params`` may
    be a ``common.Parallel`` (the split form over ``model``,
    :func:`heads_split`), without a cache."""
    if isinstance(params, C.Parallel):
        if init_cache is not None or return_cache:
            raise ValueError("the tensor-parallel Mamba-2 block is the "
                             "train step's; prefill and decode run whole")
        return _forward_parallel(params, cfg, u)
    s, d_inner, nheads, conv_dim = _dims(cfg)
    bsz, slen, _ = u.shape
    z, x, b, c, dt, conv_caches = _project_conv_full(params, cfg, u,
                                                     init_cache)
    x = x.reshape(bsz, slen, nheads, s.head_dim)
    b = b.reshape(bsz, slen, s.ngroups, s.d_state)
    c = c.reshape(bsz, slen, s.ngroups, s.d_state)
    ssm_init = init_cache["state"] if init_cache else None
    y, state = _scan(cfg, x, b, c, dt, params["dt_bias"], params["A_log"],
                     params["D"], ssm_init)
    out = _out(params, cfg, y.reshape(bsz, slen, d_inner), z)
    if return_cache:
        return out, {**conv_caches, "state": state}
    return out


def init_mamba2_cache(cfg, batch: int, device=None) -> dict:
    s, d_inner, nheads, conv_dim = _dims(cfg)
    gn = s.ngroups * s.d_state

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    cache = {"state": z(batch, nheads, s.head_dim, s.d_state)}
    if s.fused_proj:
        cache["conv"] = z(batch, s.d_conv - 1, conv_dim)
    else:
        cache["conv_x"] = z(batch, s.d_conv - 1, d_inner)
        cache["conv_b"] = z(batch, s.d_conv - 1, gn)
        cache["conv_c"] = z(batch, s.d_conv - 1, gn)
    return cache


def _conv_step(cache_conv, t, w, b):
    conv_in = torch.cat([cache_conv, t], dim=1)
    y_conv = (conv_in * w[None]).sum(dim=1, keepdim=True) + b
    return F.silu(y_conv)[:, 0], conv_in[:, 1:, :]


def mamba2_decode(params: dict, cfg, u: torch.Tensor, cache: dict):
    """Single-token recurrence.  u: (B, 1, D).  O(1) state update:
    state = state * exp(dt*A) + dt * B x;  y = C . state + D x.  Returns
    (y, cache): the new state is written into ``cache`` in place."""
    s, d_inner, nheads, conv_dim = _dims(cfg)
    dt_ = cfg.activation_dtype
    bsz = u.shape[0]
    gn = s.ngroups * s.d_state
    new_caches = {}
    if s.fused_proj:
        zxbcdt = LN.apply_linear(params["in_proj"], u, cfg.quant, dtype=dt_)
        z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
        xbc1, new_caches["conv"] = _conv_step(
            cache["conv"], xbc.to(torch.float32), params["conv_w"],
            params["conv_b"])
        x, b, c = torch.split(xbc1, [d_inner, gn, gn], dim=-1)
    else:
        z = LN.apply_linear(params["z_proj"], u, cfg.quant, dtype=dt_)
        dt = LN.apply_linear(params["dt_proj"], u, cfg.quant, dtype=dt_)
        parts = {}
        for name in ("x", "b", "c"):
            t = LN.apply_linear(params[f"{name}_proj"], u, cfg.quant,
                                dtype=dt_).to(torch.float32)
            parts[name], new_caches[f"conv_{name}"] = _conv_step(
                cache[f"conv_{name}"], t, params[f"conv_w_{name}"],
                params[f"conv_b_{name}"])
        x, b, c = parts["x"], parts["b"], parts["c"]
    x = x.reshape(bsz, nheads, s.head_dim)
    b = b.reshape(bsz, s.ngroups, s.d_state)
    c = c.reshape(bsz, s.ngroups, s.d_state)
    dt1 = F.softplus(dt.to(torch.float32)[:, 0] + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt1 * a)                         # (B, H)
    hpg = nheads // s.ngroups
    b_h = torch.repeat_interleave(b, hpg, dim=1)       # (B, H, N)
    c_h = torch.repeat_interleave(c, hpg, dim=1)
    dx = dt1[..., None] * x                            # (B, H, P)
    new_state = cache["state"] * decay[..., None, None] \
        + torch.einsum("bhp,bhn->bhpn", dx, b_h)
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_h) \
        + x * params["D"][:, None]
    out = _out(params, cfg, y.reshape(bsz, 1, d_inner), z)
    for name, t in {**new_caches, "state": new_state}.items():
        cache[name].copy_(t)
    return out, cache
