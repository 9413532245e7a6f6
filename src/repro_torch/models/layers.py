"""Dense decoder layers (the port of ``repro/models/layers.py``).

Plain functions over explicit param dicts, in PyTorch.  Layouts match the
JAX package at every public function: activations (B, S, d), heads as
their own dim (B, S, H, hd), KV caches (B, T, Kv, hd).  Packed weights go
through :func:`matvec` to the CUDA kernels; ``wo``, the attention scores
and the embedding gather stay plain tensor products, as the JAX package
leaves them to XLA.

The training forward (:func:`attention`, :func:`next_token_loss`) is
plain tensor code that autograd differentiates; the JAX package has no
backward kernels either.

Not ported yet: the sliding-window ring buffer and MoE (ROADMAP Queue 1,
item 8) and cross attention (item 10).  A windowed config raises rather
than being served or trained wrong.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDesc, dense
from repro_torch.quant.store import is_store


def W(p):
    """Weight view: decode a WeightStore leaf to dense, pass tensors through."""
    if is_store(p):
        return p.as_dense()
    return p


def matvec(p, x: torch.Tensor, tiers: torch.Tensor | None = None,
           demand: int | None = None) -> torch.Tensor:
    """x (..., K) contracted with weight p (K, *rest) -> (..., *rest).

    Packed leaves dispatch to the kernels; ``tiers`` (B,) engages per-row
    plane masks on leaves that carry a tier-drop vector, and ``demand`` (a
    Python int, the batch's minimum live tier) bounds the planes read.
    """
    if is_store(p):
        if tiers is not None:
            masks = getattr(p, "tier_plane_masks", lambda: None)()
            if masks is not None:
                return p.matmul(x, plane_mask=masks[tiers], demand_tier=demand)
        return p.matmul(x)
    return torch.tensordot(x, p.to(x.dtype), dims=1)


# --------------------------------------------------------------------------
# Norms, RoPE
# --------------------------------------------------------------------------
def rmsnorm_desc(d: int) -> ParamDesc:
    return ParamDesc((d,), (None,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (..., S) -> same shape; the half-split
    convention (pairs are (i, i + hd/2))."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / hd))).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA)
# --------------------------------------------------------------------------
def attn_descs(d: int, n_heads: int, n_kv: int, head_dim: int,
               qk_norm: bool = False, dtype=torch.float32) -> dict:
    descs = {
        "wq": ParamDesc((d, n_heads, head_dim), ("embed", "heads", None), dtype=dtype),
        "wk": ParamDesc((d, n_kv, head_dim), ("embed", "kv_heads", None), dtype=dtype),
        "wv": ParamDesc((d, n_kv, head_dim), ("embed", "kv_heads", None), dtype=dtype),
        "wo": ParamDesc((n_heads, head_dim, d), ("heads", None, "embed"), dtype=dtype),
    }
    if qk_norm:
        descs["q_norm"] = rmsnorm_desc(head_dim)
        descs["k_norm"] = rmsnorm_desc(head_dim)
    return descs


def _project_qkv(p: dict, x, positions, theta: float, tiers=None, demand=None):
    q = matvec(p["wq"], x, tiers, demand)  # (b, s, h, hd)
    k = matvec(p["wk"], x, tiers, demand)
    v = matvec(p["wv"], x, tiers, demand)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if positions is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def _gqa_scores_apply(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,Kv,hd), mask broadcastable to (B,Kv,G,S,T)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / np.sqrt(hd)
    scores = torch.where(mask, scores, torch.full((), -1e30, dtype=scores.dtype,
                                                  device=scores.device))
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, t: int, offset: int = 0, device="cpu") -> torch.Tensor:
    """(s, t) boolean mask; query i (global position offset + i) sees key
    j <= offset + i."""
    qi = offset + torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return kj <= qi


def _out_proj(p: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, W(p["wo"]).to(x.dtype))


class KVCache(NamedTuple):
    """Decode-time cache; ``pos`` and ``pad`` are PER SLOT (see the JAX
    package's ``KVCache``)."""

    k: torch.Tensor  # (B, T, Kv, hd)
    v: torch.Tensor
    pos: torch.Tensor  # (B,) int32 — tokens already in each slot's lane
    pad: torch.Tensor  # (B,) int32 — per-slot left-pad count


def kv_cache_descs(b: int, t: int, n_kv: int, head_dim: int, dtype) -> KVCache:
    return KVCache(
        k=ParamDesc((b, t, n_kv, head_dim), ("batch", "seq_kv", "kv_heads", None),
                    dtype=dtype, init="zeros"),
        v=ParamDesc((b, t, n_kv, head_dim), ("batch", "seq_kv", "kv_heads", None),
                    dtype=dtype, init="zeros"),
        pos=ParamDesc((b,), ("batch",), dtype=torch.int32, init="zeros"),
        pad=ParamDesc((b,), ("batch",), dtype=torch.int32, init="zeros"),
    )


def _no_window(window):
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention (the SWA ring buffer) is not ported yet: "
            "ROADMAP Queue 1, item 8")


def attention(p: dict, x: torch.Tensor, *, positions: torch.Tensor | None = None,
              theta: float = 10000.0, window: int | None = None,
              q_chunk: int = 2048) -> torch.Tensor:
    """Full-sequence (training) causal GQA attention over x (B, S, d).
    Sequences longer than ``q_chunk`` run in q-chunks, so the score matrix
    never exceeds (chunk x S)."""
    _no_window(window)
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, positions, theta)
    if s <= q_chunk:
        out = _gqa_scores_apply(q, k, v, causal_mask(s, s, device=x.device)[None, None, None])
    else:
        if s % q_chunk:
            raise ValueError(f"sequence length {s} is not a multiple of q_chunk={q_chunk}")
        outs = []
        for i in range(s // q_chunk):
            m = causal_mask(q_chunk, s, offset=i * q_chunk, device=x.device)
            outs.append(_gqa_scores_apply(q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                                          m[None, None, None]))
        out = torch.cat(outs, dim=1)
    return _out_proj(p, out, x)


def decode_attention(p: dict, x: torch.Tensor, cache: KVCache, *, theta: float = 10000.0,
                     window: int | None = None, use_rope: bool = True,
                     active: torch.Tensor | None = None, tiers: torch.Tensor | None = None,
                     demand: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, d).  Each slot writes its k/v at its own
    ``pos[b]`` — IN PLACE into ``cache.k``/``cache.v`` (the live cache is
    updated where it lies, no copy) — and attends over
    ``pad[b] <= idx <= pos[b]``.  Inactive lanes do not advance ``pos``."""
    _no_window(window)
    b = x.shape[0]
    t = cache.k.shape[1]
    positions = (cache.pos - cache.pad)[:, None] if use_rope else None
    q, k_new, v_new = _project_qkv(p, x, positions, theta, tiers, demand)

    slot = torch.clamp(cache.pos, max=t - 1).to(torch.int64)
    bidx = torch.arange(b, device=x.device)
    k, v = cache.k, cache.v
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)

    idx = torch.arange(t, device=x.device)
    valid = (idx[None, :] <= cache.pos[:, None]) & (idx[None, :] >= cache.pad[:, None])
    mask = valid[:, None, None, None, :]  # (B,1,1,1,T)

    out = _gqa_scores_apply(q, k.to(q.dtype), v.to(q.dtype), mask)
    y = _out_proj(p, out, x)
    step = (torch.ones((b,), dtype=torch.int32, device=x.device) if active is None
            else active.to(torch.int32))
    return y, KVCache(k=k, v=v, pos=cache.pos + step, pad=cache.pad)


def prefill_attention(p: dict, x: torch.Tensor, cache: KVCache, *,
                      positions: torch.Tensor, pad: torch.Tensor, theta: float = 10000.0,
                      window: int | None = None, tiers: torch.Tensor | None = None,
                      demand: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence cache prefill over a left-padded prompt x (B, S, d) in
    one pass: causal + left-pad masked attention, then the projected k/v
    land in cache slots [0, S) of a NEW cache (the input cache is left
    untouched, so a zeroed cache can be reused)."""
    _no_window(window)
    b, s, _ = x.shape
    t = cache.k.shape[1]
    if s > t:
        raise ValueError(f"prompt width {s} exceeds the {t}-entry cache")
    q, k_new, v_new = _project_qkv(p, x, positions, theta, tiers, demand)

    kj = torch.arange(s, device=x.device)[None, None, :]
    mask = causal_mask(s, s, device=x.device)[None] & (kj >= pad[:, None, None])
    out = _gqa_scores_apply(q, k_new, v_new, mask[:, None, None])
    y = _out_proj(p, out, x)

    k = cache.k.clone()
    v = cache.v.clone()
    k[:, :s] = k_new.to(k.dtype)
    v[:, :s] = v_new.to(v.dtype)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return y, KVCache(k=k, v=v, pos=pos, pad=pad)


def verify_attention(p: dict, x: torch.Tensor, cache: KVCache, *, start: torch.Tensor,
                     wlen: torch.Tensor, theta: float = 10000.0, use_rope: bool = True,
                     tiers: torch.Tensor | None = None,
                     demand: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """Multi-position decode for self-speculative verify: x (B, W, d) is a
    per-slot window (the last emitted token, then the drafts) fed at cache
    indices ``start + j``.

    The window's k/v overwrite cache entries ``[start, start + wlen)`` of
    each lane IN PLACE (replacing the draft-tier KV the draft ticks wrote)
    before attention runs, and window query j attends over
    ``pad <= idx <= start + j``: the entries a sequential decode of token j
    would see, through the decode step's own shapes (:func:`per_position`).
    Lanes with ``wlen == 0`` are untouched, ``pos`` included; their output
    is garbage the caller discards.  Written lanes get
    ``pos = start + wlen``; the caller rolls it back to the accepted
    prefix, and rejected entries stay in the cache, masked."""
    b, w, _ = x.shape
    t = cache.k.shape[1]
    ar_w = torch.arange(w, dtype=torch.int32, device=x.device)
    positions = (start[:, None] + ar_w[None, :] - cache.pad[:, None]) if use_rope else None
    q, k_new, v_new = _project_qkv(p, x, positions, theta, tiers, demand)

    # entry idx of lane b takes window slot idx - start[b] when that slot
    # exists, else keeps its value: one elementwise select, no scatter
    idx = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]  # (1, T)
    rel = idx - start[:, None]                                          # (B, T)
    inwin = ((rel >= 0) & (rel < wlen[:, None]))[:, :, None, None]
    relc = torch.clamp(rel, 0, w - 1).to(torch.int64)[:, :, None, None]
    k, v = cache.k, cache.v
    for dst, new in ((k, k_new), (v, v_new)):
        rows = torch.gather(new.to(dst.dtype), 1, relc.expand(-1, -1, *new.shape[2:]))
        dst.copy_(torch.where(inwin, rows, dst))

    qpos = start[:, None] + ar_w[None, :]  # (B, W)
    valid = (idx[:, None, :] <= qpos[:, :, None]) & (idx[:, None, :] >= cache.pad[:, None, None])
    kq, vq = k.to(q.dtype), v.to(q.dtype)
    y = torch.cat([_out_proj(p, _gqa_scores_apply(q[:, j:j + 1].contiguous(), kq, vq,
                                                  valid[:, j, None, None, None, :]), x)
                   for j in range(w)], dim=1)
    pos = torch.where(wlen > 0, start + wlen, cache.pos).to(torch.int32)
    return y, KVCache(k=k, v=v, pos=pos, pad=cache.pad)


def per_position(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over each position (B, 1, ...) of x (B, W, ...), concatenated.

    The verify pass runs its reductions and dense products this way (the
    norms here, the attention and ``wo`` in :func:`verify_attention`): each
    call then has the shapes of a decode step, so the library picks the
    same reduction order and a verified row equals the decoded one bit for
    bit.  Only the packed matmuls run on the whole window, where the
    kernels' own plan keeps each row's order (``kernels/qsq.py``)."""
    return torch.cat([fn(x[:, j:j + 1].contiguous()) for j in range(x.shape[1])], dim=1)


# --------------------------------------------------------------------------
# MLP (SwiGLU), embeddings, head
# --------------------------------------------------------------------------
def mlp_descs(d: int, ff: int, dtype=torch.float32) -> dict:
    return {
        "wg": dense(d, ff, "embed", "mlp", dtype=dtype),
        "wu": dense(d, ff, "embed", "mlp", dtype=dtype),
        "wd": dense(ff, d, "mlp", "embed", dtype=dtype),
    }


def mlp(p: dict, x: torch.Tensor, tiers=None, demand=None) -> torch.Tensor:
    g = F.silu(matvec(p["wg"], x, tiers, demand))
    u = matvec(p["wu"], x, tiers, demand)
    return matvec(p["wd"], g * u, tiers, demand)


def embed_descs(vocab: int, d: int, dtype=torch.float32) -> dict:
    return {
        "tok": ParamDesc((vocab, d), ("vocab", "embed"), dtype=dtype, init="normal"),
        "head": dense(d, vocab, "embed", "vocab", dtype=dtype, init="normal", scale=0.5),
    }


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return W(p["tok"])[tokens.to(torch.int64)].to(dtype)


def lm_head(p: dict, x: torch.Tensor, tiers=None, demand=None) -> torch.Tensor:
    """Logits in f32 (greedy argmax reads them as the JAX package does)."""
    return matvec(p["head"], x, tiers, demand).to(torch.float32)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits (B, S, V) against labels (B, S);
    labels < 0 are masked out."""
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    picked = torch.gather(logits, -1, torch.where(valid, labels, 0).to(torch.int64)[..., None])
    mask = valid.to(torch.float32)
    return -torch.sum((picked[..., 0] - lse) * mask) / torch.clamp(torch.sum(mask), min=1.0)
