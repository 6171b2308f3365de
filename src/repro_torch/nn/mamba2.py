"""Mamba-2 (SSD, state-space duality) mixer: the chunked parallel form for
training and prefill, and the O(1) recurrent decode step, as in the JAX
package's ``repro/nn/mamba2.py`` [arXiv:2405.21060].

The sequence is cut into chunks; within a chunk the recurrence is a masked
attention-like quadratic form, across chunks a small state (B, H, N, P) is
carried by a loop over the chunks (the reference's ``lax.scan``). All decay
arithmetic is float32. The depthwise causal conv is K shifted
multiply-adds, no convolution primitive.

The reference computes it in plain JAX outside any Pallas kernel; so does
the port, in plain PyTorch. Its three-operand einsums are written as an
explicit order of products, so that none builds the (B, nc, c, N, H)
outer product a left-to-right contraction would: the masked decay times
C·Bᵀ, then a batched product over the chunk's positions. On a model mesh
(:func:`mamba_forward_sharded`) ``inner`` and the heads are split over
``model``.

Caches (:class:`MambaCache`) hold the last K-1 pre-conv inputs and the
float32 state; :func:`mamba_decode` updates their tensors in place, as the
attention decode does its KV cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn.layers import (DTYPES, Linear, RMSNorm, linear_apply,
                                   rmsnorm_apply)


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, d_inner + 2N): the last pre-conv inputs
    state: torch.Tensor   # (B, H, N, P) float32: the SSM state
    length: int           # tokens already seen, for the whole batch


class Mamba2(nn.Module):
    """``wz``/``wx`` (d, d_inner), ``wB``/``wC`` (d, N), ``wdt`` (d, H) and
    ``out`` (d_inner, d) linears; ``conv_w`` (K, d_inner + 2N) and
    ``conv_b``; float32 ``A_log`` = log(linspace(1, 16, H)), ``dt_bias``
    = -2 and ``D`` = 1; the gated ``norm`` over d_inner."""

    def __init__(self, gen: torch.Generator, cfg, device="cuda"):
        super().__init__()
        dt = DTYPES[cfg.param_dtype]
        D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        kw = dict(dtype=dt, device=device)
        self.wz = Linear(gen, (D,), (di,), **kw)
        self.wx = Linear(gen, (D,), (di,), **kw)
        self.wB = Linear(gen, (D,), (N,), **kw)
        self.wC = Linear(gen, (D,), (N,), **kw)
        self.wdt = Linear(gen, (D,), (H,), **kw)
        self.out = Linear(gen, (di,), (D,), **kw)
        conv = torch.empty((cfg.ssm_conv, di + 2 * N), dtype=torch.float32,
                           device=device)
        conv.normal_(generator=gen)
        self.conv_w = nn.Parameter((conv / np.sqrt(cfg.ssm_conv)).to(dt))
        self.conv_b = nn.Parameter(torch.zeros((di + 2 * N,), **kw))
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H,
                                                           **f32)))
        self.dt_bias = nn.Parameter(torch.full((H,), -2.0, **f32))
        self.D = nn.Parameter(torch.ones((H,), **f32))
        self.norm = RMSNorm(di, dt, device)


def mamba_init(gen: torch.Generator, cfg, device="cuda") -> Mamba2:
    return Mamba2(gen, cfg, device)


def _depthwise_causal_conv(u, w, b, history=None):
    """u: (B, S, C); w: (K, C). Causal: y_t = sum_k w[k] * u_{t-K+1+k},
    in float32, returned in u's dtype. ``history``: optional (B, K-1, C)
    left context (decode, chunked prefill); zeros without it."""
    K = w.shape[0]
    B, S, C = u.shape
    if history is None:
        hist = torch.zeros((B, K - 1, C), dtype=u.dtype, device=u.device)
    else:
        hist = history.to(u.dtype)
    ext = torch.cat([hist, u], dim=1).to(torch.float32)    # (B, S+K-1, C)
    wf = w.to(torch.float32)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=u.device)
    for k in range(K):
        y = y + ext[:, k:k + S] * wf[k]
    return (y + b.to(torch.float32)).to(u.dtype)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD scan. xh: (B, S, H, P); dt: (B, S, H); A: (H,) negative; Bm/Cm:
    (B, S, N). Returns (y (B, S, H, P) in xh's dtype, final state (B, H,
    N, P) float32). S is zero-padded to whole chunks after the caller's
    softplus, so the padded steps (dt = 0) leave the state as it was."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    f32 = torch.float32
    a = (dt.to(f32) * A.to(f32)).reshape(Bsz, nc, chunk, H)
    xb = (xh.to(f32) * dt.to(f32)[..., None]).reshape(Bsz, nc, chunk, H, P)
    Bc = Bm.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, chunk, N)

    cum = torch.cumsum(a, dim=2)                           # (B, nc, c, H)
    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xb_j
    CB = torch.matmul(Cc, Bc.transpose(-1, -2))            # (B, nc, i, j)
    Ldec = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, i, j, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    # mask BEFORE exp: the upper triangle is +large (cum decreases), and
    # exp(+large) * 0 in the backward would give NaN gradients
    Ldec = torch.where(tri[None, None, :, :, None], Ldec, -1e30)
    M = CB[..., None] * torch.exp(Ldec)                    # (B, nc, i, j, H)
    # sum over j, one (i, j) x (j, P) product a (batch, chunk, head)
    y_intra = torch.matmul(M.permute(0, 1, 4, 2, 3),
                           xb.permute(0, 1, 3, 2, 4))      # (B, nc, H, i, P)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)               # (B, nc, i, H, P)

    # chunk states: S_n = sum_j exp(cum_end - cum_j) B_j (x) xb_j
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)           # (B, nc, c, H)
    xw = (dec_end[..., None] * xb).reshape(Bsz, nc, chunk, H * P)
    states = torch.matmul(Bc.transpose(-1, -2), xw)        # (B, nc, N, H·P)
    states = states.reshape(Bsz, nc, N, H, P).permute(0, 1, 3, 2, 4)

    # inter-chunk recurrence, emitting the state *before* each chunk
    g = torch.exp(cum[:, :, -1, :])                        # (B, nc, H)
    R = (torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
         if init_state is None else init_state.to(f32))
    prevs = []
    for n in range(nc):
        prevs.append(R)
        R = R * g[:, n, :, None, None] + states[:, n]
    R_prev = torch.stack(prevs, dim=1)                     # (B, nc, H, N, P)

    # y_inter_i = exp(cum_i) C_i . R_prev
    CR = torch.matmul(Cc, R_prev.permute(0, 1, 3, 2, 4).reshape(
        Bsz, nc, N, H * P)).reshape(Bsz, nc, chunk, H, P)
    y_inter = torch.exp(cum)[..., None] * CR
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(xh.dtype), R


def _min_prompt(cfg) -> int:
    return cfg.ssm_conv - 1


def _dims(params, cfg):
    """(d_inner, N, H, P) of ``params``, read off its tensors: the whole
    mixer's or one model shard's."""
    return (params.wx.w.shape[-1], params.wB.w.shape[-1],
            params.wdt.w.shape[-1], cfg.ssm_head_dim)


def _gated(params, cfg, x, init_cache: Optional[MambaCache] = None):
    """Everything before the gated norm: (y * silu(z) (B, S, d_inner) in
    the activation dtype, the pre-conv inputs (B, S, d_inner + 2N), the
    final state)."""
    adt = DTYPES[cfg.activation_dtype]
    B, S, D = x.shape
    di, N, H, P = _dims(params, cfg)
    z = linear_apply(params.wz, x, "bsd,de->bse", compute_dtype=adt)
    xs = linear_apply(params.wx, x, "bsd,de->bse", compute_dtype=adt)
    Bm = linear_apply(params.wB, x, "bsd,dn->bsn", compute_dtype=adt)
    Cm = linear_apply(params.wC, x, "bsd,dn->bsn", compute_dtype=adt)
    dt_raw = linear_apply(params.wdt, x, "bsd,dh->bsh", compute_dtype=adt)

    u_pre = torch.cat([xs, Bm, Cm], dim=-1)
    hist = init_cache.conv if init_cache is not None else None
    u = _depthwise_causal_conv(u_pre, params.conv_w, params.conv_b, hist)
    u = F.silu(u.to(torch.float32)).to(adt)
    xs, Bm, Cm = u[..., :di], u[..., di:di + N], u[..., di + N:]

    dt = F.softplus(dt_raw.to(torch.float32) + params.dt_bias.to(
        torch.float32))
    A = -torch.exp(params.A_log.to(torch.float32))
    xh = xs.reshape(B, S, H, P)
    init_state = init_cache.state if init_cache is not None else None
    y, final_state = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                  init_state)
    y = y + params.D.to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, di)
    return y * F.silu(z.to(torch.float32)).to(y.dtype), u_pre, final_state


def mamba_forward(params: Mamba2, cfg, x, *,
                  init_cache: Optional[MambaCache] = None,
                  return_cache: bool = False):
    """Train/prefill forward. x: (B, S, D) -> (B, S, D); with
    ``return_cache`` also the :class:`MambaCache` after the S steps, which
    needs S >= K-1 (the conv history is the last K-1 pre-conv inputs)."""
    adt = DTYPES[cfg.activation_dtype]
    S = x.shape[1]
    if return_cache and S < _min_prompt(cfg):
        raise ValueError(f"a Mamba cache needs a prompt of at least "
                         f"{_min_prompt(cfg)} tokens (ssm_conv - 1), got {S}")
    g, u_pre, final_state = _gated(params, cfg, x, init_cache)
    y = rmsnorm_apply(params.norm, g, cfg.norm_eps)
    out = linear_apply(params.out, y, "bse,ed->bsd", compute_dtype=adt)
    if return_cache:
        cache = MambaCache(conv=u_pre[:, S - _min_prompt(cfg):],
                           state=final_state, length=S)
        return out, cache
    return out


def init_mamba_cache(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> MambaCache:
    """An empty cache: conv in ``dtype`` (float32 by default), the state
    in float32, length 0."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, H, N, P), dtype=torch.float32,
                          device=device),
        length=0)


def _gated_decode(params, cfg, x, conv, state):
    """One token before the gated norm: (y * silu(z) (B, 1, d_inner),
    the conv window (B, K, d_inner + 2N), the new state (B, H, N, P))."""
    adt = DTYPES[cfg.activation_dtype]
    B = x.shape[0]
    di, N, H, P = _dims(params, cfg)
    f32 = torch.float32

    z = linear_apply(params.wz, x, "bsd,de->bse", compute_dtype=adt)
    pre = torch.cat([
        linear_apply(params.wx, x, "bsd,de->bse", compute_dtype=adt),
        linear_apply(params.wB, x, "bsd,dn->bsn", compute_dtype=adt),
        linear_apply(params.wC, x, "bsd,dn->bsn", compute_dtype=adt),
    ], dim=-1)                                             # (B, 1, di+2N)
    dt_raw = linear_apply(params.wdt, x, "bsd,dh->bsh", compute_dtype=adt)

    window = torch.cat([conv.to(adt), pre], dim=1)         # (B, K, C)
    u = (window.to(f32) * params.conv_w.to(f32)[None]).sum(dim=1,
                                                           keepdim=True)
    u = F.silu(u + params.conv_b.to(f32)).to(adt)
    xs, Bm, Cm = u[..., :di], u[..., di:di + N], u[..., di + N:]

    dt = F.softplus(dt_raw.to(f32) + params.dt_bias.to(f32))[:, 0]  # (B, H)
    A = -torch.exp(params.A_log.to(f32))
    g = torch.exp(dt * A)                                  # (B, H)
    xh = xs.reshape(B, H, P).to(f32)
    Bf, Cf = Bm[:, 0].to(f32), Cm[:, 0].to(f32)
    # B_m dt_h x_hp, as the reference's einsum multiplies them
    upd = Bf[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :]
    state = state * g[:, :, None, None] + upd              # (B, H, N, P)
    y = torch.einsum("bm,bhmp->bhp", Cf, state)
    y = y + params.D.to(f32)[None, :, None] * xh
    y = y.reshape(B, 1, di).to(adt)
    return y * F.silu(z.to(f32)).to(y.dtype), window, state


def mamba_decode(params: Mamba2, cfg, x, cache: MambaCache):
    """Single-token decode. x: (B, 1, D). Returns (y (B, 1, D), cache);
    the cache's conv and state tensors are updated in place."""
    adt = DTYPES[cfg.activation_dtype]
    g, window, state = _gated_decode(params, cfg, x, cache.conv,
                                     cache.state)
    y = rmsnorm_apply(params.norm, g, cfg.norm_eps)
    out = linear_apply(params.out, y, "bse,ed->bsd", compute_dtype=adt)
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache._replace(length=cache.length + 1)


# -- on a model mesh ----------------------------------------------------------
# ``inner`` and ``ssm_heads`` are split over ``model`` where both divide;
# ``wB``/``wC`` are read whole; ``out`` is row-parallel. The conv runs over
# the concatenated (x, B, C) channels, whose even split does not fall on
# the x|B|C boundary: a position gathers ``conv_w``/``conv_b`` and takes
# its x channels and B and C. The gated norm's mean square over d_inner is
# all-reduced.

def _split(P) -> bool:
    return P.split("wx.w", 1) and P.split("wdt.w", 1)


def _x_range(cfg, mesh, pos, split: bool):
    w = cfg.d_inner // (mesh.axis_size("model") if split else 1)
    lo = (mesh.index(pos, "model") if split else 0) * w
    return lo, lo + w


def _local(P, cfg, mesh, pos, split: bool):
    from types import SimpleNamespace
    lo, hi = _x_range(cfg, mesh, pos, split)
    di, N = cfg.d_inner, cfg.ssm_state
    inner = {1: "model"} if split else {}
    heads = {0: "model"} if split else {}
    cols = torch.cat([torch.arange(lo, hi), torch.arange(di, di + 2 * N)])
    conv_w = P.local("conv_w", pos)
    cols = cols.to(conv_w.device)
    return SimpleNamespace(
        wz=P.linear("wz", pos, inner), wx=P.linear("wx", pos, inner),
        wB=P.linear("wB", pos), wC=P.linear("wC", pos),
        wdt=P.linear("wdt", pos, inner),
        out=P.linear("out", pos, {0: "model"} if split else {}),
        conv_w=conv_w.index_select(1, cols),
        conv_b=P.local("conv_b", pos).index_select(0, cols),
        A_log=P.local("A_log", pos, heads),
        dt_bias=P.local("dt_bias", pos, heads),
        D=P.local("D", pos, heads),
        norm=SimpleNamespace(scale=P.local("norm.scale", pos)[lo:hi]))


def _norm_out(ps, cfg, mesh, gs, split: bool):
    """The gated norm (its mean square all-reduced over ``model``) and
    the row-parallel ``out``, at every position."""
    from repro_torch.nn.collectives import REDUCE_DTYPE, all_reduce
    adt = DTYPES[cfg.activation_dtype]
    var = {pos: None for pos in gs}
    if split:
        sq = {pos: (g.to(torch.float32) ** 2).sum(dim=-1, keepdim=True)
              for pos, g in gs.items()}
        var = {pos: s / cfg.d_inner
               for pos, s in all_reduce(sq, mesh, "model").items()}
    ys = {}
    for pos, g in gs.items():
        y = rmsnorm_apply(ps[pos].norm, g, cfg.norm_eps, var=var[pos])
        ys[pos] = linear_apply(ps[pos].out, y, "bse,ed->bsd",
                               compute_dtype=REDUCE_DTYPE if split else adt)
    if not split:
        return ys
    return {p: y.to(adt) for p, y in all_reduce(ys, mesh, "model").items()}


def _full_channels(cfg, mesh, rows, split: bool):
    """{pos: (B, K, x channels + 2N)} -> {pos: (B, K, d_inner + 2N)}:
    the x channels gathered over ``model``."""
    from repro_torch.nn.collectives import all_gather
    if not split:
        return rows
    w = cfg.d_inner // mesh.axis_size("model")
    xs = all_gather({p: r[..., :w] for p, r in rows.items()}, mesh,
                    "model", -1)
    return {p: torch.cat([xs[p], r[..., w:]], dim=-1)
            for p, r in rows.items()}


def _write(sharded, pos, full_rows) -> None:
    """Write a position's rows (the batch block it holds, every other
    dimension whole) into its shard of ``sharded``."""
    c = sharded.coord(pos)
    box = sharded.box(c)
    sharded.shards[c].copy_(full_rows[(slice(None),) + tuple(
        slice(a, b) for a, b in box[1:])])


def mamba_forward_sharded(P, cfg, mesh, hs,
                          cache: Optional[MambaCache] = None):
    """:func:`mamba_forward` at every position of ``mesh``; with ``cache``
    (a MambaCache of Sharded tensors) its conv history and state are
    written in place, as a prefill does. Returns {pos: y}."""
    split = _split(P)
    ps = {pos: _local(P, cfg, mesh, pos, split) for pos in mesh.positions()}
    gs, tails, states = {}, {}, {}
    for pos in mesh.positions():
        gs[pos], u_pre, states[pos] = _gated(ps[pos], cfg, hs[pos])
        S = u_pre.shape[1]
        if cache is not None:
            if S < _min_prompt(cfg):
                raise ValueError(f"a Mamba cache needs a prompt of at least "
                                 f"{_min_prompt(cfg)} tokens, got {S}")
            tails[pos] = u_pre[:, S - _min_prompt(cfg):]
    if cache is not None:
        with torch.no_grad():
            tails = _full_channels(cfg, mesh, tails, split)
            for pos in mesh.positions():
                _write(cache.conv, pos, tails[pos])
                cache.state.shards[cache.state.coord(pos)].copy_(states[pos])
    return _norm_out(ps, cfg, mesh, gs, split)


def mamba_decode_sharded(P, cfg, mesh, hs, cache: MambaCache):
    """:func:`mamba_decode` on a mesh with a cache of Sharded tensors,
    updated in place. Returns ({pos: y}, cache)."""
    split = _split(P)
    di = cfg.d_inner
    ps, gs, windows, states = {}, {}, {}, {}
    for pos in mesh.positions():
        ps[pos] = _local(P, cfg, mesh, pos, split)
        lo, hi = _x_range(cfg, mesh, pos, split)
        hist = cache.conv.local(pos, {0: cache.conv.spec.axes(0)})
        hist = torch.cat([hist[..., lo:hi], hist[..., di:]], dim=-1)
        state = cache.state.shards[cache.state.coord(pos)].to(
            hs[pos].device)
        gs[pos], win, states[pos] = _gated_decode(ps[pos], cfg, hs[pos],
                                                  hist, state)
        windows[pos] = win[:, 1:]
    windows = _full_channels(cfg, mesh, windows, split)
    for pos in mesh.positions():      # every position has read its history
        _write(cache.conv, pos, windows[pos])
        cache.state.shards[cache.state.coord(pos)].copy_(states[pos])
    return (_norm_out(ps, cfg, mesh, gs, split),
            cache._replace(length=cache.length + 1))
