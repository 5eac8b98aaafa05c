"""Mamba-1 selective-state-space mixer (falcon-mamba, hymba's SSM heads).

The port of the JAX package's ``models/mamba.py``, with its dtype policy:
the projections and the causal depthwise conv run in the compute dtype,
dt, B, C and the scan in float32. The prefill/forward scan walks the
sequence in chunks of ``cfg.ssm_chunk`` steps and carries only the
(B, d_inner, state) float32 state from one chunk to the next, as JAX's
chunked ``lax.scan`` does: a chunk's decay factors exp(dt·A) and inputs
dt·B·x are formed in one pass each, then one fused multiply-add a step
(``torch.addcmul``) advances the state, and one product with C reads the
chunk's outputs. Live state is (chunk, B, d_inner, state), never
(B, S, d_inner, state). Training differentiates the scan through
``SelectiveScan``, the counterpart of JAX's ``jax.checkpoint`` on each
chunk: it keeps the state at each chunk's start and recomputes one chunk
at a time in the backward. ``selective_scan_ref``, autograd through the
same loop, is its plain version. The JAX package leaves the scan outside
any Pallas kernel, and so does the port: it is plain torch (ROADMAP,
performance item "the selective scan's step loop").

Decoding carries (h, conv window) explicitly, O(1) per token; the port
writes them into the cache's tensors in place.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) each step loop
runs as whole-chunk ops that move the same bytes and hold the same live
memory, one op where the loop dispatches one a step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_mamba(gen: torch.Generator, cfg: ModelConfig):
    D = cfg.d_model
    di = cfg.resolved_d_inner
    n = cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    K = cfg.conv_kernel
    dev = gen.device
    # S4-style A init: -(1..n) per channel
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None, :]
    return {
        "in_proj": dense_init(gen, (D, 2 * di)),
        "conv_w": dense_init(gen, (K, di), in_axis_size=K),
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * n)),
        "dt_proj": dense_init(gen, (dtr, di), in_axis_size=dtr),
        "dt_bias": torch.full((di,), -4.6, device=dev),   # softplus ≈ 0.01
        "A_log": torch.log(a.repeat(di, 1)),
        "D": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, (di, D)),
    }


def mamba_dims(cfg: ModelConfig):
    """Logical dims of ``init_mamba``'s leaves (``runtime/sharding.py``)."""
    return {
        "in_proj": ("d_model", "d_inner2"),
        "conv_w": ("conv_k", "d_inner"),
        "conv_b": ("d_inner",),
        "x_proj": ("d_inner", "dt_plus"),
        "dt_proj": ("dt_rank", "d_inner"),
        "dt_bias": ("d_inner",),
        "A_log": ("d_inner", "ssm_state"),
        "D": ("d_inner",),
        "out_proj": ("d_inner", "d_model"),
    }


def _ssm_inputs(p, x, cfg: ModelConfig):
    """Shared pre-scan projection. x (B,S,D) → (xr, z), each (B,S,d_inner)."""
    xz = x @ p["in_proj"].to(x.dtype)                   # (B,S,2di)
    xr, z = torch.chunk(xz, 2, dim=-1)
    return xr, z


def _post_conv(p, xr, cfg: ModelConfig):
    """(xr after SiLU, dt, B, C): dt/B/C in float32."""
    n, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    dt_ = xr.dtype
    xr = F.silu(xr)
    proj = xr @ p["x_proj"].to(dt_)                     # (..., dtr+2n)
    dt_r = proj[..., :dtr]
    Bc = proj[..., dtr: dtr + n].to(torch.float32)
    Cc = proj[..., dtr + n:].to(torch.float32)
    pre = ((dt_r @ p["dt_proj"].to(dt_)).to(torch.float32)
           + p["dt_bias"].to(torch.float32))
    dt = torch.logaddexp(pre, torch.zeros((), device=pre.device))  # softplus
    return xr, dt, Bc, Cc


def _scan_chunk(A, h, xc, dtc, Bc, Cc):
    """One chunk of the scan, time-major: xc/dtc (T,B,di), Bc/Cc (T,B,n)
    float32, h (B,di,n) → (h, y (T,B,di)). A decode step is a chunk of
    one step."""
    da = torch.exp(dtc[..., None] * A)                  # (T,B,di,n)
    u = dtc[..., None] * Bc[:, :, None, :] * xc[..., None]
    if u.is_meta:
        # shapes only (a dry run): the step loop as whole-chunk ops of the
        # same bytes and live memory, the T states and their stack
        hs = torch.addcmul(u, da, u)
        y = torch.einsum("tbdn,tbn->tbd",
                         hs.clone(memory_format=torch.contiguous_format), Cc)
        return hs[-1].clone(), y
    hs = []
    for t in range(xc.shape[0]):
        h = torch.addcmul(u[t], da[t], h)               # da·h + dt·B·x
        hs.append(h)
    y = torch.einsum("tbdn,tbn->tbd", torch.stack(hs), Cc)
    return h, y


def _chunk_states(A, h, xc, dtc, Bc):
    """``_scan_chunk``'s decays and states again, for the backward: → (da,
    hs), each (T,B,di,n), the states written over dt·B·x in place."""
    da = torch.exp(dtc[..., None] * A)
    hs = dtc[..., None] * Bc[:, :, None, :] * xc[..., None]
    if hs.is_meta:                      # shapes only: one op, the same bytes
        return da, hs.addcmul_(da, hs)
    for t in range(xc.shape[0]):
        h = hs[t].addcmul_(da[t], h)
    return da, hs


def _check_chunk(S: int, chunk: int) -> None:
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the scan "
                         f"chunk {chunk} (cfg.ssm_chunk)")


def _scan_chunks(A, x, dt, Bc, Cc, chunk: int, h0):
    """The chunk loop: → (y (B,S,di), [the state before each chunk])."""
    B, S, di = x.shape
    xs, dts = x.transpose(0, 1), dt.transpose(0, 1)     # time-major
    Bs, Cs = Bc.transpose(0, 1), Cc.transpose(0, 1)
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    starts, ys = [], []
    for s in range(0, S, chunk):
        starts.append(h)
        h, y = _scan_chunk(A, h, xs[s: s + chunk], dts[s: s + chunk],
                           Bs[s: s + chunk], Cs[s: s + chunk])
        ys.append(y)
    return torch.cat(ys).transpose(0, 1), starts


class SelectiveScan(torch.autograd.Function):
    """The chunked scan with JAX's chunk checkpoint (``mamba_forward``'s
    ``outer`` scan over ``jax.checkpoint``-ed chunks): the forward keeps
    only the state at each chunk's start, n_chunks × (B, d_inner, n), never
    a state a step; the backward walks the chunks from last to first,
    recomputes one chunk's decays and states from its start state, runs the
    reverse recurrence gh_t = C_t·gy_t + exp(dt_{t+1}·A)·gh_{t+1} (one
    fused multiply-add a step) and forms the chunk's gradients in
    whole-chunk passes. Live memory is one chunk's (T, B, d_inner, n)
    tensors."""

    @staticmethod
    def forward(ctx, A, x, dt, Bc, Cc, chunk, h0):
        y, starts = _scan_chunks(A, x, dt, Bc, Cc, chunk, h0)
        ctx.chunk = chunk
        ctx.save_for_backward(A, x, dt, Bc, Cc, torch.stack(starts))
        return y

    @staticmethod
    def backward(ctx, gy):
        A, x, dt, Bc, Cc, starts = ctx.saved_tensors
        T = ctx.chunk
        xs, dts = x.transpose(0, 1), dt.transpose(0, 1)
        Bs, Cs = Bc.transpose(0, 1), Cc.transpose(0, 1)
        gys = gy.transpose(0, 1)
        gx, gdt = torch.empty_like(xs), torch.empty_like(dts)
        gB, gC = torch.empty_like(Bs), torch.empty_like(Cs)
        gA = torch.zeros_like(A)
        gh = None                       # the gradient of the chunk's last state
        for c in range(starts.shape[0] - 1, -1, -1):
            sl = slice(c * T, (c + 1) * T)
            xc, dtc, Bcc, Ccc, gyc = xs[sl], dts[sl], Bs[sl], Cs[sl], gys[sl]
            da, hs = _chunk_states(A, starts[c], xc, dtc, Bcc)
            g = gyc[..., None] * Ccc[:, :, None, :]     # C_t·gy_t, (T,B,di,n)
            if gh is not None:
                g[-1] += gh
            if g.is_meta:               # shapes only: one op, the same bytes
                g[:-1].addcmul_(da[1:], g[1:])
            else:
                for t in range(T - 2, -1, -1):
                    g[t].addcmul_(da[t + 1], g[t + 1])
            gh = da[0] * g[0]                          # → the state before
            h_prev = torch.cat([starts[c][None], hs[:-1]])
            gz = g * h_prev * da                       # d/d(dt·A)
            gA += torch.einsum("tbdn,tbd->dn", gz, dtc)
            gBx = torch.einsum("tbdn,tbn->tbd", g, Bcc)
            gx[sl] = gBx * dtc
            gdt[sl] = gBx * xc + torch.einsum("tbdn,dn->tbd", gz, A)
            gB[sl] = torch.einsum("tbdn,tbd->tbn", g, dtc * xc)
            gC[sl] = torch.einsum("tbd,tbdn->tbn", gyc, hs)
        return (gA, gx.transpose(0, 1), gdt.transpose(0, 1),
                gB.transpose(0, 1), gC.transpose(0, 1), None,
                gh if ctx.needs_input_grad[6] else None)


def selective_scan(A, x, dt, Bc, Cc, chunk: int, h0=None):
    """The selective scan h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t·x_t,
    y_t = h_t·C_t over chunks of ``chunk`` steps, all float32: A (di,n);
    x, dt (B,S,di); Bc, Cc (B,S,n); h0 (B,di,n) or zeros → y (B,S,di).
    Differentiable through ``SelectiveScan``, which keeps one state a
    chunk."""
    _check_chunk(x.shape[1], chunk)
    return SelectiveScan.apply(A, x, dt, Bc, Cc, chunk, h0)


def selective_scan_ref(A, x, dt, Bc, Cc, chunk: int, h0=None):
    """The plain version of ``selective_scan``: the same chunk loop with
    autograd through every step, so a backward keeps every step's state.
    The yardstick of ``SelectiveScan``'s gradients in the tests and on the
    card; nothing on the model's path calls it."""
    _check_chunk(x.shape[1], chunk)
    return _scan_chunks(A, x, dt, Bc, Cc, chunk, h0)[0]


def mamba_forward(p, x, cfg: ModelConfig, h0=None):
    """Training/prefill forward. x (B,S,D) → (B,S,D)."""
    S = x.shape[1]
    xr, z = _ssm_inputs(p, x, cfg)

    # causal depthwise conv along S
    K = cfg.conv_kernel
    xr_pad = F.pad(xr, (0, 0, K - 1, 0))
    w = p["conv_w"].to(x.dtype)
    conv = sum(xr_pad[:, i: i + S, :] * w[i] for i in range(K))
    xr = conv + p["conv_b"].to(x.dtype)

    xr, dt, Bc, Cc = _post_conv(p, xr, cfg)
    A = -torch.exp(p["A_log"].to(torch.float32))        # (di,n)
    y = selective_scan(A, xr.to(torch.float32), dt, Bc, Cc,
                       min(cfg.ssm_chunk, S), h0=h0)

    y = y.to(x.dtype) + xr * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   dtype=torch.float32, device=None):
    di, n, K = cfg.resolved_d_inner, cfg.ssm_state, cfg.conv_kernel
    return {
        "h": torch.zeros((n_layers, batch, di, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, K - 1, di), dtype=dtype,
                            device=device),
    }


def ssm_cache_dims():
    """Logical dims of ``init_ssm_cache``'s leaves."""
    return {"h": ("layer", "batch", "d_inner", "ssm_state"),
            "conv": ("layer", "batch", "conv_k", "d_inner")}


def mamba_decode_step(p, x, cache_l, cfg: ModelConfig):
    """x (B, 1, D) → (out (B,1,D), cache_l). ``cache_l`` holds this layer's
    ``h`` and ``conv``; unlike the JAX package, which returns a new cache,
    the port writes the new state into those tensors in place and returns
    the same dict."""
    xr, z = _ssm_inputs(p, x, cfg)                      # (B,1,di)
    xr = xr[:, 0]
    conv_c = cache_l["conv"]
    window = torch.cat([conv_c, xr[:, None, :].to(conv_c.dtype)], dim=1)
    conv = (torch.einsum("bkd,kd->bd", window.to(x.dtype),
                         p["conv_w"].to(x.dtype))
            + p["conv_b"].to(x.dtype))
    xc, dt, Bc, Cc = _post_conv(p, conv[:, None, :], cfg)
    xc, dt, Bc, Cc = xc[:, 0], dt[:, 0], Bc[:, 0], Cc[:, 0]
    A = -torch.exp(p["A_log"].to(torch.float32))
    h, y = _scan_chunk(A, cache_l["h"], xc.to(torch.float32)[None], dt[None],
                       Bc[None], Cc[None])
    y = y[0].to(x.dtype) + xc * p["D"].to(x.dtype)
    y = y * F.silu(z[:, 0])
    out = (y @ p["out_proj"].to(x.dtype))[:, None, :]
    cache_l["h"].copy_(h)
    conv_c.copy_(window[:, 1:])
    return out, cache_l
