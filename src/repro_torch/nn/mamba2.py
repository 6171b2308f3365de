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
C·Bᵀ, then a batched product over the chunk's positions. The reference's
``constrain(...)`` calls (``cfg.ssd_constrain``) are sharding hints for a
model mesh and have no counterpart here.

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


def mamba_forward(params: Mamba2, cfg, x, *,
                  init_cache: Optional[MambaCache] = None,
                  return_cache: bool = False):
    """Train/prefill forward. x: (B, S, D) -> (B, S, D); with
    ``return_cache`` also the :class:`MambaCache` after the S steps, which
    needs S >= K-1 (the conv history is the last K-1 pre-conv inputs)."""
    adt = DTYPES[cfg.activation_dtype]
    B, S, D = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    if return_cache and S < _min_prompt(cfg):
        raise ValueError(f"a Mamba cache needs a prompt of at least "
                         f"{_min_prompt(cfg)} tokens (ssm_conv - 1), got {S}")

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
    y = rmsnorm_apply(params.norm, y * F.silu(z.to(torch.float32)).to(
        y.dtype), cfg.norm_eps)
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


def mamba_decode(params: Mamba2, cfg, x, cache: MambaCache):
    """Single-token decode. x: (B, 1, D). Returns (y (B, 1, D), cache);
    the cache's conv and state tensors are updated in place."""
    adt = DTYPES[cfg.activation_dtype]
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32

    z = linear_apply(params.wz, x, "bsd,de->bse", compute_dtype=adt)
    pre = torch.cat([
        linear_apply(params.wx, x, "bsd,de->bse", compute_dtype=adt),
        linear_apply(params.wB, x, "bsd,dn->bsn", compute_dtype=adt),
        linear_apply(params.wC, x, "bsd,dn->bsn", compute_dtype=adt),
    ], dim=-1)                                             # (B, 1, di+2N)
    dt_raw = linear_apply(params.wdt, x, "bsd,dh->bsh", compute_dtype=adt)

    window = torch.cat([cache.conv.to(adt), pre], dim=1)   # (B, K, C)
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
    state = cache.state * g[:, :, None, None] + upd        # (B, H, N, P)
    y = torch.einsum("bm,bhmp->bhp", Cf, state)
    y = y + params.D.to(f32)[None, :, None] * xh
    y = y.reshape(B, 1, di).to(adt)
    y = rmsnorm_apply(params.norm, y * F.silu(z.to(f32)).to(y.dtype),
                      cfg.norm_eps)
    out = linear_apply(params.out, y, "bse,ed->bsd", compute_dtype=adt)
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache._replace(length=cache.length + 1)
