"""Decoder layers (the port of ``repro/models/layers.py``).

Plain functions over explicit param dicts, in PyTorch.  Layouts match the
JAX package at every public function: activations (B, S, d), heads as
their own dim (B, S, H, hd), KV caches (B, T, Kv, hd).  Packed weights go
through :func:`matvec` to the CUDA kernels; ``wo``, the attention scores
and the embedding gather stay plain tensor products, as the JAX package
leaves them to XLA.

The training forward (:func:`attention`, :func:`next_token_loss`) is
plain tensor code that autograd differentiates; the JAX package has no
backward kernels either.

:func:`moe` is the MoE FFN with capacity routing; its experts are
decoded to dense at load, as the JAX package serves them, and contract in
batched products over the expert axis.

With a sliding window (``window``), the training attention masks keys
older than the window, and the decode cache is a ring of
``min(cache_len, window)`` entries: token i lives at slot ``i % t``.

:func:`cross_attention` attends over K/V filled ahead of time by
:func:`cross_kv` (the vision tokens or the encoder's frames), with no mask
and no RoPE; its ``wq`` and the ``wk``/``wv`` of :func:`cross_kv` go
through :func:`matvec`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDesc, constrain, data_shard_count, dense
from repro_torch.quant.store import is_store


def W(p):
    """Weight view: decode a WeightStore leaf to dense, pass tensors through."""
    if is_store(p):
        # qsqlint: disable=QSQ001 -- decode-at-consumption for leaves no kernel
        # takes (norms, embeddings, MoE experts, SSM mixers); matmul weights go
        # through matvec()
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


@functools.lru_cache(maxsize=64)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The (hd/2,) f32 RoPE frequencies on ``device``, copied there once: a
    captured serving step may not copy from the host."""
    half = hd // 2
    return torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / hd))).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (..., S) -> same shape; the half-split
    convention (pairs are (i, i + hd/2))."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(hd, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(seq: int, d: int) -> np.ndarray:
    """The (seq, d) f32 sinusoid table, [sin | cos], computed in numpy as the
    JAX package computes it (bit-equal)."""
    pos = np.arange(seq, dtype=np.float32)[:, None]
    i = np.arange(d // 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10000.0, 2.0 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


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


def causal_mask(s: int, t: int, offset: int = 0, window: int | None = None,
                device="cpu") -> torch.Tensor:
    """(s, t) boolean mask; query i (global position offset + i) sees key
    j iff j <= offset + i and (no window or offset + i - j < window)."""
    qi = offset + torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (qi - kj < window)
    return m


def _out_proj(p: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, W(p["wo"]).to(x.dtype))


class KVCache(NamedTuple):
    """Decode-time cache; ``pos`` and ``pad`` are PER SLOT (see the JAX
    package's ``KVCache``).  With a sliding window the buffers are a ring
    of ``t <= window`` entries; otherwise they are full-length."""

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


def attention(p: dict, x: torch.Tensor, *, positions: torch.Tensor | None = None,
              theta: float = 10000.0, window: int | None = None,
              q_chunk: int = 2048, causal: bool = True) -> torch.Tensor:
    """Full-sequence (training) GQA attention over x (B, S, d), causal
    unless ``causal=False`` (the encoder's); ``positions=None`` applies no
    RoPE.

    Sequences longer than ``q_chunk`` run in q-chunks, so the score matrix
    never exceeds (chunk x S); with a sliding window shorter than
    ``S - q_chunk`` each chunk also sees only a ``(window + q_chunk)`` kv
    slice, so windowed attention is sub-quadratic.  As in the JAX package,
    only a sequence of at most ``q_chunk`` reads ``causal``: the chunked
    branches are causal."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, positions, theta)
    if s <= q_chunk:
        m = (causal_mask(s, s, window=window, device=x.device) if causal
             else torch.ones((s, s), dtype=torch.bool, device=x.device))
        return _out_proj(p, _gqa_scores_apply(q, k, v, m[None, None, None]), x)
    if s % q_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of q_chunk={q_chunk}")
    outs = []
    if window is not None and window + q_chunk < s:
        # k/v left-padded by ``window``: chunk i's slice starts at global
        # position i * q_chunk - window
        kp = F.pad(k, (0, 0, 0, 0, window, 0))
        vp = F.pad(v, (0, 0, 0, 0, window, 0))
        kv_len = window + q_chunk
        ar_q = torch.arange(q_chunk, device=x.device)[:, None]
        ar_k = torch.arange(kv_len, device=x.device)[None, :]
        for i in range(s // q_chunk):
            start = i * q_chunk
            qpos, kpos = start + ar_q, start - window + ar_k
            m = (kpos <= qpos) & (qpos - kpos < window) & (kpos >= 0)
            outs.append(_gqa_scores_apply(q[:, start:start + q_chunk],
                                          kp[:, start:start + kv_len],
                                          vp[:, start:start + kv_len], m[None, None, None]))
    else:
        for i in range(s // q_chunk):
            m = causal_mask(q_chunk, s, offset=i * q_chunk, window=window, device=x.device)
            outs.append(_gqa_scores_apply(q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                                          m[None, None, None]))
    return _out_proj(p, torch.cat(outs, dim=1), x)


def ring_entries(pos: torch.Tensor, pad: torch.Tensor,
                 t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A sliding-window ring of ``t`` entries at a decode step -> (the slot
    (B,) int64 the step's k/v go to, ``pos % t``; the (B, t) mask of the
    entries its query sees).  An entry's age counts the writes since it, so
    its global index is ``pos - age``: it is seen iff it is one of the last
    ``min(pos + 1, t)`` writes and not left pad."""
    slot = (pos % t).to(torch.int64)
    idx = torch.arange(t, device=pos.device)
    age = (slot[:, None] - idx[None, :]) % t
    valid = (age < torch.clamp(pos + 1, max=t)[:, None]) & (pos[:, None] - age >= pad[:, None])
    return slot, valid


def decode_attention(p: dict, x: torch.Tensor, cache: KVCache, *, theta: float = 10000.0,
                     window: int | None = None, use_rope: bool = True,
                     active: torch.Tensor | None = None, tiers: torch.Tensor | None = None,
                     demand: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, d).  Each slot writes its k/v at its own
    ``pos[b]`` (``pos[b] % t`` in a sliding-window ring) — IN PLACE into
    ``cache.k``/``cache.v`` (the live cache is updated where it lies, no
    copy) — and attends over ``pad[b] <= idx <= pos[b]``, or in a ring over
    the last ``min(pos[b] + 1, t)`` writes that are not left pad.  ``pos``
    advances in place too; inactive lanes do not advance it."""
    b = x.shape[0]
    t = cache.k.shape[1]
    positions = (cache.pos - cache.pad)[:, None] if use_rope else None
    q, k_new, v_new = _project_qkv(p, x, positions, theta, tiers, demand)

    if window is not None:
        slot, valid = ring_entries(cache.pos, cache.pad, t)
    else:
        slot = torch.clamp(cache.pos, max=t - 1).to(torch.int64)
        idx = torch.arange(t, device=x.device)
        valid = (idx[None, :] <= cache.pos[:, None]) & (idx[None, :] >= cache.pad[:, None])
    bidx = torch.arange(b, device=x.device)
    k, v = cache.k, cache.v
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)
    mask = valid[:, None, None, None, :]  # (B,1,1,1,T)

    out = _gqa_scores_apply(q, k.to(q.dtype), v.to(q.dtype), mask)
    y = _out_proj(p, out, x)
    step = (torch.ones((b,), dtype=torch.int32, device=x.device) if active is None
            else active.to(torch.int32))
    cache.pos.add_(step)
    return y, cache


def prefill_attention(p: dict, x: torch.Tensor, cache: KVCache, *,
                      positions: torch.Tensor, pad: torch.Tensor, theta: float = 10000.0,
                      window: int | None = None, tiers: torch.Tensor | None = None,
                      demand: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence cache prefill over a left-padded prompt x (B, S, d) in
    one pass: causal (windowed) + left-pad masked attention, then the
    projected k/v land in cache slots [0, S) of a NEW cache (the input
    cache is left untouched, so a zeroed cache can be reused).  A
    sliding-window ring shorter than the prompt keeps its last t tokens,
    token i at slot ``i % t``."""
    b, s, _ = x.shape
    t = cache.k.shape[1]
    if s > t and window is None:
        raise ValueError(f"prompt width {s} exceeds the {t}-entry cache")
    q, k_new, v_new = _project_qkv(p, x, positions, theta, tiers, demand)

    kj = torch.arange(s, device=x.device)[None, None, :]
    mask = causal_mask(s, s, window=window, device=x.device)[None] & (kj >= pad[:, None, None])
    out = _gqa_scores_apply(q, k_new, v_new, mask[:, None, None])
    y = _out_proj(p, out, x)

    k = cache.k.clone()
    v = cache.v.clone()
    if s <= t:
        k[:, :s] = k_new.to(k.dtype)
        v[:, :s] = v_new.to(v.dtype)
    else:
        keep = torch.arange(s - t, s, device=x.device)
        k[:, keep % t] = k_new[:, keep].to(k.dtype)
        v[:, keep % t] = v_new[:, keep].to(v.dtype)
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
    ``pos = start + wlen``, in place; the caller rolls it back to the
    accepted prefix, and rejected entries stay in the cache, masked."""
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
    cache.pos.copy_(torch.where(wlen > 0, start + wlen, cache.pos))
    return y, cache


def cross_attention(p: dict, x: torch.Tensor,
                    kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Attention of x (B, S, d) over precomputed K/V ``kv = (k, v)``, each
    (B, T, Kv, hd): every query sees every one of the T entries."""
    q = matvec(p["wq"], x)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
    k, v = kv
    mask = torch.ones((1, 1, 1, 1, k.shape[1]), dtype=torch.bool, device=x.device)
    return _out_proj(p, _gqa_scores_apply(q, k.to(q.dtype), v.to(q.dtype), mask), x)


def cross_kv(p: dict, enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross K/V of ``enc`` (B, T, d): ((B, T, Kv, hd), (B, T, Kv, hd))."""
    k = matvec(p["wk"], enc)
    v = matvec(p["wv"], enc)
    if "k_norm" in p:
        k = rmsnorm(k, p["k_norm"])
    return k, v


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


# --------------------------------------------------------------------------
# MoE with capacity routing
# --------------------------------------------------------------------------
def moe_descs(d: int, ff: int, n_experts: int, dtype=torch.float32) -> dict:
    return {
        "router": dense(d, n_experts, "embed", None, dtype=torch.float32, init="small"),
        "wg": ParamDesc((n_experts, d, ff), ("experts", "embed", "mlp"), dtype=dtype),
        "wu": ParamDesc((n_experts, d, ff), ("experts", "embed", "mlp"), dtype=dtype),
        "wd": ParamDesc((n_experts, ff, d), ("experts", "mlp", "embed"), dtype=dtype),
    }


class Routing(NamedTuple):
    """Where :func:`moe` sent each of the T * k assignments (token-major)."""

    expert: torch.Tensor  # (T*k,) int64 expert id, the sentinel E for dead lanes
    pos: torch.Tensor     # (T*k,) int64 position in the expert's buffer
    keep: torch.Tensor    # (T*k,) bool: a live assignment within capacity
    weight: torch.Tensor  # (T*k,) f32 renormalised top-k weight (0 on dead lanes)


def _route(router: torch.Tensor, xt: torch.Tensor, top_k: int, cap: int,
           active: torch.Tensor | None) -> tuple[Routing, torch.Tensor, torch.Tensor]:
    """:func:`moe_route` with the load-balancing terms apart: (routing, the
    mean router probability of each expert (E,), the top-1 counts (E,))."""
    t = xt.shape[0]
    e = router.shape[-1]
    probs = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32), dim=-1)  # (T, E)
    topw, topi = torch.topk(probs, top_k, dim=-1)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    # Switch-style load-balancing terms over every token; the top-1 counts go
    # through scatter_add_ (bincount's output length would sync the host)
    me = torch.mean(probs, dim=0)
    counts = torch.zeros(e, dtype=torch.float32, device=xt.device).scatter_add_(
        0, topi[:, 0], torch.ones(t, dtype=torch.float32, device=xt.device))

    flat_e = topi.reshape(-1)
    flat_w = topw.reshape(-1)
    if active is not None:
        act = (active.reshape(-1) != 0)
        act = act[:, None].expand(act.shape[0], t // act.shape[0] * top_k).reshape(-1)
        flat_e = torch.where(act, flat_e, e)
        flat_w = flat_w * act.to(flat_w.dtype)
    order = torch.argsort(flat_e, stable=True)
    rank = torch.argsort(order)  # each assignment's index in expert-major order
    starts = torch.searchsorted(flat_e[order],
                                torch.arange(e, dtype=flat_e.dtype, device=xt.device),
                                side="left")
    pos = rank - starts[torch.clamp(flat_e, max=e - 1)]
    keep = (pos < cap) & (flat_e < e)
    return Routing(expert=flat_e, pos=pos, keep=keep, weight=flat_w), me, counts


def moe_route(router: torch.Tensor, xt: torch.Tensor, *, top_k: int, cap: int,
              active: torch.Tensor | None = None) -> tuple[Routing, torch.Tensor]:
    """Top-k token choice over xt (T, d) -> (routing, aux loss).

    The router runs in f32.  Each expert takes its first ``cap``
    assignments in token-major order (a stable sort by expert id); the rest
    drop.  An inactive lane's assignments go to the sentinel expert E,
    which sorts after every real one, so a dead lane claims no capacity;
    ``active`` holds one flag a lane or one a token.  Shapes only decide
    ``cap``; nothing here syncs with the host."""
    r, me, counts = _route(router, xt, top_k, cap, active)
    return r, router.shape[-1] * torch.sum(me * (counts / xt.shape[0]))


def expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: (E, C, d) -> (E, C, d), as
    batched products on the experts' dense weights."""
    g = F.silu(torch.bmm(buf, W(p["wg"]).to(buf.dtype)))
    u = torch.bmm(buf, W(p["wu"]).to(buf.dtype))
    return torch.bmm(g * u, W(p["wd"]).to(buf.dtype))


def _dispatch(p: dict, xt: torch.Tensor, r: Routing, cap: int, top_k: int) -> torch.Tensor:
    """xt (T, d) through the experts :func:`moe_route` chose -> (T, d)."""
    t, d = xt.shape
    e = p["router"].shape[-1]
    ec = torch.clamp(r.expert, max=e - 1)
    slot = torch.where(r.keep, r.pos, cap)
    tok = torch.arange(t, device=xt.device)[:, None].expand(t, top_k).reshape(-1)

    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((ec, slot), xt[tok])
    yb = expert_ffn(p, buf[:, :cap])

    w = (r.weight * r.keep.to(r.weight.dtype)).to(xt.dtype)
    ya = (yb[ec, torch.clamp(slot, max=cap - 1)] * w[:, None]).view(t, top_k, d)
    y = ya[:, 0]
    for j in range(1, top_k):
        y = y + ya[:, j]
    return y


def moe(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
        active: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice MoE over x (B, S, d) -> (y, aux loss), the JAX
    package's ``moe``: capacity routing local to each data shard.

    The T = B * S tokens split into ``data_shard_count()`` equal shards in
    order (one shard with no activation rules installed, or where T does
    not split into shards of at least ``max(top_k, 4)`` tokens).  In each
    shard every expert gets a buffer of ``cap = ceil(T_shard * k * cf / E)``
    tokens; overflowing assignments drop, and dropped and dead ones land in
    a trash slot ``cap`` that is cut off before the expert FFN.  ``active``
    (B,) takes dead lanes out of the competition (:func:`moe_route`).  Each
    kept slot receives one token, so the dispatch is a plain indexed write;
    the k weighted expert outputs of a token are summed in index order, so
    the result does not depend on the order of a scatter's atomics.  The
    aux loss takes the mean router probability over every token and the
    top-1 counts shard by shard, as the JAX package does."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    t = b * s
    shards = data_shard_count()
    if shards <= 1 or t % shards or t // shards < max(top_k, 4):
        shards = 1
    tl = t // shards
    cap = int(np.ceil(tl * top_k * capacity_factor / e))
    if shards == 1:
        xt = x.reshape(t, d)
        r, aux = moe_route(p["router"], xt, top_k=top_k, cap=cap, active=active)
        return _dispatch(p, xt, r, cap, top_k).reshape(b, s, d), aux
    xs = constrain(x.reshape(shards, tl, d), ("batch", None, None))
    act = None
    if active is not None:  # one flag a token, split like the tokens
        act = (active.reshape(b, 1) != 0).expand(b, s).reshape(shards, tl)
    ys, mes, ces = [], [], []
    for i in range(shards):
        r, me, counts = _route(p["router"], xs[i], top_k, cap, None if act is None else act[i])
        ys.append(_dispatch(p, xs[i], r, cap, top_k))
        mes.append(me)
        ces.append(counts / tl)
    aux = e * torch.sum(torch.stack(mes).mean(0) * torch.stack(ces).mean(0))
    return torch.cat(ys).reshape(b, s, d), aux


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
