"""Mamba2 (SSD, state-space duality) mixer (the port of
``repro/models/ssm.py``), arXiv:2405.21060.

Training and the whole-sequence forward use the chunked SSD algorithm:
quadratic within chunks of length L, linear across chunks through a
state-passing recurrence (a Python loop over chunks, in the JAX scan's
order).  Decode keeps a constant-size state (B, H, N, P) and a causal-conv
buffer of the last W - 1 inputs, and writes both IN PLACE into the state it
is given, as the attention decode writes its KV cache.

Head layout: d_inner = n_heads * head_dim (P); one shared B/C per group
(n_groups = 1 for mamba2-1.3b; jamba uses 8); head h reads group
``h // (n_heads // n_groups)``.

Every projection is decoded to dense through ``layers.W`` and contracted
with ``torch.matmul``, as the JAX package contracts ``x @ W(p)``: packed
leaves are dequantized at use, outside the kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDesc, dense
from repro_torch.models.layers import W, rmsnorm, rmsnorm_desc


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    state: int  # N
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


def ssm_descs(c: SSMConfig, dtype=torch.float32) -> dict:
    gn = c.n_groups * c.state
    return {
        "wz": dense(c.d_model, c.d_inner, "embed", "heads_inner", dtype=dtype),
        "wx": dense(c.d_model, c.d_inner, "embed", "heads_inner", dtype=dtype),
        "wB": dense(c.d_model, gn, "embed", None, dtype=dtype),
        "wC": dense(c.d_model, gn, "embed", None, dtype=dtype),
        "wdt": dense(c.d_model, c.n_heads, "embed", None, dtype=dtype),
        "conv_x": ParamDesc((c.conv_width, c.d_inner), (None, "heads_inner"), dtype=dtype,
                            init="normal"),
        "conv_B": ParamDesc((c.conv_width, gn), (None, None), dtype=dtype, init="normal"),
        "conv_C": ParamDesc((c.conv_width, gn), (None, None), dtype=dtype, init="normal"),
        "a_log": ParamDesc((c.n_heads,), (None,), init="zeros"),
        "D": ParamDesc((c.n_heads,), (None,), init="ones"),
        "dt_bias": ParamDesc((c.n_heads,), (None,), init="zeros"),
        "norm": rmsnorm_desc(c.d_inner),
        "wo": dense(c.d_inner, c.d_model, "heads_inner", "embed", dtype=dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, D), w (W, D) -> silu of (B, S, D),
    multiplied in x's dtype."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    return F.silu(out)


def _segsum(dlog: torch.Tensor) -> torch.Tensor:
    """dlog (..., L, H) -> (..., H, L, L) with [i, j] = sum_{k=j+1..i} dlog_k
    for i >= j, -inf otherwise (the log of the intra-chunk decay matrix)."""
    length = dlog.shape[-2]
    cs = torch.cumsum(torch.movedim(dlog, -1, -2), dim=-1)  # (..., H, L)
    diff = cs[..., :, None] - cs[..., None, :]  # [i, j] = cs_i - cs_j
    i = torch.arange(length, device=dlog.device)[:, None]
    j = torch.arange(length, device=dlog.device)[None, :]
    return torch.where(i >= j, diff, torch.full((), float("-inf"), dtype=diff.dtype,
                                                device=diff.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan over x (B, S, H, P), dt (B, S, H) post-softplus,
    a (H,) negative decay rates, bmat/cmat (B, S, G, N) and an optional
    initial state h0 (B, H, N, P) -> (y (B, S, H, P) f32, final state
    (B, H, N, P) f32).  S is padded to whole chunks; padded steps have
    x = 0 and dt = 0 (decay 1), so they neither emit nor move the state."""
    b, s_orig, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g  # heads per group
    if s_orig % chunk:
        pad = chunk - s_orig % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    s = x.shape[1]
    nc = s // chunk
    f32 = torch.float32

    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    bc = bmat.reshape(b, nc, chunk, g, n).to(f32)
    cc = cmat.reshape(b, nc, chunk, g, n).to(f32)
    xg = xc.reshape(b, nc, chunk, g, hpg, p)

    dlog = dtc * a.to(f32)  # (b, nc, L, H), negative
    lmat = torch.exp(_segsum(dlog))  # (b, nc, H, L, L)

    # intra-chunk, the quadratic dual form: scores C_i . B_j of the group,
    # broadcast over its heads
    cb = torch.einsum("bclgn,bcmgn->bcglm", cc, bc).reshape(b, nc, g, 1, chunk, chunk)
    lm = lmat.reshape(b, nc, g, hpg, chunk, chunk)
    dtj = torch.movedim(dtc.reshape(b, nc, chunk, g, hpg), 2, 4)  # (b, nc, g, hpg, L)
    att = cb * lm * dtj[:, :, :, :, None, :]
    y_intra = torch.einsum("bcghlm,bcmghp->bclghp", att, xg)  # (b, nc, L, g, hpg, p)

    # end-of-chunk states: S_c = sum_j exp(cs_L - cs_j) dt_j B_j (x) x_j
    csum = torch.cumsum(dlog, dim=2)  # (b, nc, L, H)
    wdt = torch.exp(csum[:, :, -1:, :] - csum) * dtc  # (b, nc, L, H)
    s_c = torch.einsum("bclgn,bclgh,bclghp->bcghnp", bc, wdt.reshape(b, nc, chunk, g, hpg),
                       xg)  # (b, nc, g, hpg, n, p)

    # inter-chunk recurrence over the chunks, in order
    total_decay = torch.exp(csum[:, :, -1, :]).reshape(b, nc, g, hpg)
    hcur = (torch.zeros((b, g, hpg, n, p), dtype=f32, device=x.device) if h0 is None
            else h0.reshape(b, g, hpg, n, p).to(f32))
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(hcur)
        hcur = total_decay[:, ci, :, :, None, None] * hcur + s_c[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)  # (b, nc, g, hpg, n, p): the state entering each

    # inter-chunk contribution: y_i += C_i . (decay from chunk start to i * h_prev)
    y_inter = torch.einsum("bclgn,bcghnp,bclgh->bclghp", cc, h_prev,
                           torch.exp(csum).reshape(b, nc, chunk, g, hpg))
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y, hcur.reshape(b, h, n, p)


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, H, N, P) f32
    conv_x: torch.Tensor  # (B, W-1, d_inner)
    conv_B: torch.Tensor  # (B, W-1, G*N)
    conv_C: torch.Tensor  # (B, W-1, G*N)


def ssm_state_descs(c: SSMConfig, batch: int, dtype=torch.float32) -> SSMState:
    gn = c.n_groups * c.state
    w = c.conv_width - 1
    return SSMState(
        h=ParamDesc((batch, c.n_heads, c.state, c.head_dim),
                    ("batch", "heads_inner", None, None), dtype=torch.float32, init="zeros"),
        conv_x=ParamDesc((batch, w, c.d_inner), ("batch", None, "heads_inner"), dtype=dtype,
                         init="zeros"),
        conv_B=ParamDesc((batch, w, gn), ("batch", None, None), dtype=dtype, init="zeros"),
        conv_C=ParamDesc((batch, w, gn), ("batch", None, None), dtype=dtype, init="zeros"),
    )


def state_at(st: SSMState, i: int) -> SSMState:
    """Entry ``i`` of a stacked state (views: decode writes land in the stack)."""
    return SSMState(*(t[i] for t in st))


def ssm_forward(p: dict, x: torch.Tensor, c: SSMConfig) -> torch.Tensor:
    """Full-sequence mixer forward: x (B, S, d_model) -> (B, S, d_model)."""
    b, s, _ = x.shape
    z = x @ W(p["wz"]).to(x.dtype)
    xs = _causal_conv(x @ W(p["wx"]).to(x.dtype), W(p["conv_x"]).to(x.dtype))
    bs = _causal_conv(x @ W(p["wB"]).to(x.dtype), W(p["conv_B"]).to(x.dtype))
    cs = _causal_conv(x @ W(p["wC"]).to(x.dtype), W(p["conv_C"]).to(x.dtype))
    dt = softplus((x @ W(p["wdt"]).to(x.dtype)).to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    xh = xs.reshape(b, s, c.n_heads, c.head_dim)
    bm = bs.reshape(b, s, c.n_groups, c.state)
    cm = cs.reshape(b, s, c.n_groups, c.state)
    y, _ = ssd_chunked(xh, dt, a, bm, cm, c.chunk)
    y = y + p["D"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, s, c.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return y @ W(p["wo"]).to(x.dtype)


def _conv_ssd_step(p: dict, state: SSMState, xin: torch.Tensor, bin_: torch.Tensor,
                   cin: torch.Tensor, dtin: torch.Tensor, c: SSMConfig) -> torch.Tensor:
    """The decode step's causal convs and SSD recurrence on the projected
    token (xin (B, d_inner), bin_/cin (B, G*N), dtin (B, H) f32) ->
    y (B, d_inner) in xin's dtype, the skip included; writes the new state
    and conv buffers into ``state`` in place."""
    b = xin.shape[0]
    f32 = torch.float32

    def conv_step(buf, new, w):
        # buf (B, W-1, D) holds the previous W-1 inputs; the conv runs in f32
        full = torch.cat([buf, new[:, None]], dim=1)  # (B, W, D)
        out = torch.einsum("bwd,wd->bd", full.to(f32), w.to(f32))
        return F.silu(out).to(xin.dtype), full[:, 1:]

    xs, nconv_x = conv_step(state.conv_x, xin, p["conv_x"])
    bs, nconv_b = conv_step(state.conv_B, bin_, p["conv_B"])
    cs, nconv_c = conv_step(state.conv_C, cin, p["conv_C"])

    dt = softplus(dtin + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["a_log"])  # (H,)
    decay = torch.exp(dt * a)  # (B, H)

    hpg = c.n_heads // c.n_groups
    xh = xs.reshape(b, c.n_heads, c.head_dim).to(f32)

    def per_head(m):  # (B, G*N) -> (B, H, N): head h takes group h // hpg
        g = m.reshape(b, c.n_groups, 1, c.state).to(f32)
        return g.expand(b, c.n_groups, hpg, c.state).reshape(b, c.n_heads, c.state)

    bmh, cmh = per_head(bs), per_head(cs)
    hnew = (decay[..., None, None] * state.h
            + (dt[..., None] * bmh)[..., None] * xh[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", cmh, hnew) + p["D"][None, :, None] * xh
    for dst, new in ((state.h, hnew), (state.conv_x, nconv_x), (state.conv_B, nconv_b),
                     (state.conv_C, nconv_c)):
        dst.copy_(new)
    return y.reshape(b, c.d_inner).to(xin.dtype)


def ssm_decode(p: dict, x: torch.Tensor, state: SSMState,
               c: SSMConfig) -> tuple[torch.Tensor, SSMState]:
    """Single-token decode: x (B, 1, d_model) -> (B, 1, d_model).  The new
    recurrent state and conv buffers are written into ``state`` in place,
    which comes back as it went in."""
    xt = x[:, 0]  # (B, d)
    z = xt @ W(p["wz"]).to(x.dtype)
    y = _conv_ssd_step(p, state, xt @ W(p["wx"]).to(x.dtype), xt @ W(p["wB"]).to(x.dtype),
                       xt @ W(p["wC"]).to(x.dtype),
                       (xt @ W(p["wdt"]).to(x.dtype)).to(torch.float32), c)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return (y @ W(p["wo"]).to(x.dtype))[:, None, :], state
