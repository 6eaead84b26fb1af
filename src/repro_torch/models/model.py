"""Top-level model API: init, forward, loss, prefill, decode (the
reference's ``models/model.py``).

One entry point for all ten registry families:

* decoder-only LMs (dense, moe, ssm, hybrid, the vlm backbone) through
  ``transformer.py``'s float stack;
* encoder-decoder (whisper) through ``encdec.py``;
* stub frontends: ``batch["embeds"]``, where present, takes the token
  embedding's place (precomputed patch or frame embeddings).

``init_model`` places the weights on ``device``, the card unless the
caller asks for the CPU, and raises without a card; the other functions
run where the weights are.  In ``binary`` mode the packed linears' XNOR
route launches K5 and K4 on the card and runs their plain versions on
the CPU (``quant.backend``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import encdec as ED
from repro_torch.models import linear as LN
from repro_torch.models import transformer as TF
from repro_torch.models.cnn import _check_device
from repro_torch.tree import tree_map

# Sequence rows of one loss chunk: the (B, chunk, V) float32 logits are
# the most of them that ever exist (vocabularies here reach 256k).
LOSS_CHUNK = 512


def init_model(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Float32 weights drawn from ``gen`` (on the generator's device) and
    placed on ``device``; the decoder stack is placed a group at a time."""
    device = _check_device(device)

    def put(tree):
        return tree_map(lambda t: t.to(device), tree)

    p: dict = {
        "embed": put(C.init_embedding(gen, cfg.vocab_size, cfg.d_model)),
        "ln_out": put(C.init_norm(gen, cfg.norm_type, cfg.d_model)),
    }
    if cfg.encoder_layers:
        p["encdec"] = put(ED.init_encdec_stack(gen, cfg))
    else:
        p["stack"] = TF.init_stack(gen, cfg, device=device)
    if not cfg.tie_embeddings:
        p["head"] = put(LN.init_linear(gen, cfg.d_model, cfg.vocab_size))
    return p


def _device(params: dict) -> torch.device:
    return params["embed"]["table"].device


def _embed_in(params: dict, cfg, batch: dict) -> torch.Tensor:
    if batch.get("embeds") is not None:
        return batch["embeds"].to(cfg.activation_dtype)
    dt = cfg.activation_dtype
    x = C.embed(params["embed"], batch["tokens"], dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)


def _logits(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    x = C.apply_norm(cfg.norm_type, params["ln_out"], x)
    if cfg.tie_embeddings:
        logits = C.unembed(params["embed"], x, cfg.activation_dtype)
    else:
        logits = LN.apply_linear(params["head"], x, cfg.quant,
                                 dtype=cfg.activation_dtype)
    return C.softcap(logits, cfg.logit_softcap)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward(params: dict, cfg, batch: dict, *, remat: bool = True
            ) -> torch.Tensor:
    """Full-sequence forward -> final hidden states (B, S, D).

    batch: {"tokens": (B, S) integers} and/or {"embeds": (B, S, D)}; for
    enc-dec also {"enc_embeds": (B, S_enc, D)}.  ``remat``: under
    autograd, keep only each layer's input and recompute the rest in the
    backward pass (``common.remat``); it changes no value.
    """
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    if cfg.encoder_layers:
        enc_out = ED.encode(params["encdec"], cfg,
                            batch["enc_embeds"].to(x.device), remat=remat)
        return ED.decode_train(params["encdec"], cfg, x, enc_out, positions,
                               remat=remat)
    return TF.stack_forward(params["stack"], cfg, x, positions, remat=remat)


def loss_chunks(s: int) -> tuple[int, int]:
    """(rows a chunk, chunks) of :func:`loss_fn` over a sequence of
    ``s``."""
    chunk = min(LOSS_CHUNK, s)
    return chunk, -(-s // chunk)


def _vocab_parallel_nll(par, params: dict, cfg, xs: torch.Tensor,
                        ls: torch.Tensor):
    """(log-sum-exp, target logit), float32 (B, chunk), of one chunk over
    the vocabulary slices of ``par`` (a ``common.Parallel``: the tied
    table's slices, or the untied head's column slices).  The normed
    hidden state is fanned out to the positions (``par.fan``: float32
    copies, whose float32 partial gradients are summed once); position j
    makes its columns of the logits (the tied product on its table slice,
    or its column slice of the head, as ``linear.apply_linear`` with
    ``column``), softcapped per element, and reduces them to a float32
    partial log-sum-exp and the target logit of the labels in its slice
    (0 for the rest, and for labels of -1).  The partials are gathered
    over ``model`` on ``home`` and combined by one more log-sum-exp; the
    target logits are summed, one non-zero term a row.  The (B, chunk, V)
    logits never exist."""
    x = C.apply_norm(cfg.norm_type, params["ln_out"], xs)
    dt = cfg.activation_dtype
    lses, tgts, lo = [], [], 0
    for t, xj, dev in zip(par.trees, par.fan(x), par.devices):
        if cfg.tie_embeddings:
            logits = LN.share_product(xj, t["table"].T, dt)
        else:
            logits = LN.apply_linear(t, xj, cfg.quant, dtype=dt,
                                     column=True)
        logits = C.softcap(logits, cfg.logit_softcap).to(torch.float32)
        n = logits.shape[-1]
        lj = ls.to(dev)
        own = (lj >= lo) & (lj < lo + n)
        idx = (lj - lo).clamp(0, n - 1).to(torch.int64)[..., None]
        tgts.append(torch.where(own, torch.gather(logits, -1, idx)[..., 0],
                                0.0))
        lses.append(torch.logsumexp(logits, dim=-1, keepdim=True))
        lo += n
    return torch.logsumexp(par.gather(lses), dim=-1), par.reduce(tgts)


def loss_traffic(cfg, rows: int) -> list:
    """The traffic entries (``common.Parallel``) of one vocabulary-
    parallel loss chunk of ``rows`` (batch x chunk) rows: the normed
    hidden state fanned out, the float32 partial log-sum-exps gathered,
    the float32 target logits summed."""
    return (C.fan_traffic(rows * cfg.d_model, cfg.activation_dtype)
            + [("gather", rows, 4), ("reduce", rows, 4)])


def loss_fn(params: dict, cfg, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy, a float32 scalar: the mean over the
    labels that are >= 0 (``batch["labels"]``, (B, S)).

    Chunked over the sequence as the reference's: the hidden states and
    labels are padded to whole chunks of ``min(LOSS_CHUNK, S)`` rows (the
    labels with -1, which count for nothing), and each chunk's logits are
    made, reduced to its summed loss and valid count, and dropped.  Under
    autograd each chunk runs under ``torch.utils.checkpoint``, so the
    backward pass remakes its logits too: (B, S, V) logits never exist.

    Where the head (the tied table, or the untied head's weight) is a
    ``common.Parallel`` split over the vocabulary (the sharded train
    step), each chunk runs vocabulary-parallel
    (:func:`_vocab_parallel_nll`), recomputed whole (``common.remat``),
    so its collectives run in the forward and again in the recompute.
    """
    x = forward(params, cfg, batch)
    labels = batch["labels"].to(x.device)
    b, s = labels.shape
    chunk, n = loss_chunks(s)
    x = F.pad(x, (0, 0, 0, n * chunk - s))
    labels = F.pad(labels, (0, n * chunk - s), value=-1)
    head = params["embed"] if cfg.tie_embeddings else params.get("head")

    def chunk_loss(xs, ls, par):
        if par is not None:
            lse, tgt = _vocab_parallel_nll(par, params, cfg, xs, ls)
        else:
            logits = _logits(params, cfg, xs).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            idx = ls.clamp(min=0).to(torch.int64)[..., None]
            tgt = torch.gather(logits, -1, idx)[..., 0]
        valid = (ls >= 0).to(torch.float32)
        return ((lse - tgt) * valid).sum(), valid.sum()

    body = C.remat(chunk_loss, True)
    par = head if isinstance(head, C.Parallel) else None
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        rows = slice(i * chunk, (i + 1) * chunk)
        nll, valid = body(x[:, rows], labels[:, rows], par)
        tot, cnt = tot + nll, cnt + valid
    return tot / torch.clamp(cnt, min=1.0)


def logits_fn(params: dict, cfg, batch: dict) -> torch.Tensor:
    """(B, S, V) logits."""
    return _logits(params, cfg, forward(params, cfg, batch, remat=False))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(params: dict, cfg, batch: int, max_len: int,
               enc_len: int | None = None) -> dict:
    """The decode cache for ``batch`` sequences of up to ``max_len``
    positions, on the params' device."""
    if cfg.encoder_layers:
        return ED.init_encdec_cache(params["encdec"], cfg, batch, max_len,
                                    enc_len or max_len)
    return {"stack": TF.init_cache(cfg, batch, max_len,
                                   device=_device(params))}


def prefill(params: dict, cfg, batch: dict, max_len: int):
    """Full-sequence prefill -> (last-token logits (B, 1, V), cache).  For
    the encoder-decoder the cache is None (its decode cache comes from
    ``init_cache`` and ``encdec.precompute_cross_kv``), as in the
    reference."""
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    if cfg.encoder_layers:
        enc_out = ED.encode(params["encdec"], cfg,
                            batch["enc_embeds"].to(x.device))
        x = ED.decode_train(params["encdec"], cfg, x, enc_out, positions)
        return _logits(params, cfg, x[:, -1:]), None
    x, cache = TF.stack_prefill(params["stack"], cfg, x, positions, max_len)
    return _logits(params, cfg, x[:, -1:]), {"stack": cache}


def decode_step(params: dict, cfg, tokens: torch.Tensor, cache: dict,
                idx: int, *, enc_out: torch.Tensor | None = None):
    """One new token for every sequence.  tokens: (B, 1) integers; ``idx``
    is the absolute position being written.  Returns (logits (B, 1, V),
    cache): the step is written into ``cache`` in place (clone it first to
    keep the old one)."""
    del enc_out
    dt = cfg.activation_dtype
    x = C.embed(params["embed"], tokens, dt)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    if cfg.encoder_layers:
        x, _ = ED.decode_step(params["encdec"], cfg, x, cache, idx)
    else:
        x, _ = TF.stack_decode(params["stack"], cache["stack"], cfg, x, idx)
    return _logits(params, cfg, x), cache
