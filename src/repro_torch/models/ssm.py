"""Mamba-2 (SSD, state-space duality) block: chunked dual form for
train/prefill, constant-state recurrence for decode.
Counterpart of ``repro.models.ssm``.

Follows the Mamba-2 formulation [arXiv:2405.21060]:
    S_t = exp(dt_t · A_h) · S_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · S_t + D_h · x_t
with per-head scalar decay A_h, grouped B/C (G groups), depthwise causal
conv on the (x, B, C) streams, and a gated RMSNorm before out-projection.

The chunked dual form computes intra-chunk interactions as a masked
attention-like product and carries the inter-chunk state through a loop
over chunks — O(T·Q) live memory instead of O(T²).

Projections are split (z/x/B/C/dt) as in the JAX package; the depthwise
conv splits likewise (per-channel weights make the split exactly
equivalent to the fused conv).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, ParamGroup, dense_init,
                                       pdtype, rms_norm, uniform_init)


class SSMParams(ParamGroup):
    """w_z/w_x (D, di), w_b/w_c (D, G*N), w_dt (D, H); depthwise conv
    conv_x (W, di) + conv_x_b (di,), conv_bc (W, 2*G*N) + conv_bc_b;
    float32 a_log, dt_bias, d_skip (H,); norm_scale (di,); w_out (di, D)."""
    FIELDS = ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x", "conv_x_b",
              "conv_bc", "conv_bc_b", "a_log", "dt_bias", "d_skip",
              "norm_scale", "w_out")


class SSMState(NamedTuple):
    """A layer's decode state; decode updates its tensors in place."""
    s: torch.Tensor        # (B, G, HG, P, N) float32 — ssm state
    conv_x: torch.Tensor   # (B, W-1, di) pre-activation ring
    conv_bc: torch.Tensor  # (B, W-1, 2*G*N)
    pos: torch.Tensor      # () int32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h = di // s.head_dim
    return di, h, s.n_groups, s.d_state, s.head_dim


def init_ssm(gen, cfg: ModelConfig, device=None) -> SSMParams:
    s = cfg.ssm
    di, h, g, n, p = _dims(cfg)
    dt = pdtype(cfg)
    dev = gen.device if gen is not None else device
    a_init = uniform_init(gen, (h,), 1.0, 16.0, device=device)
    dt_floor, dt_ceil = 1e-3, 1e-1
    dt_init = torch.exp(uniform_init(gen, (h,), 0.0, 1.0, device=device)
                        * (math.log(dt_ceil) - math.log(dt_floor))
                        + math.log(dt_floor))
    f32 = torch.float32
    return SSMParams(
        w_z=dense_init(gen, (cfg.d_model, di), dt, device=device),
        w_x=dense_init(gen, (cfg.d_model, di), dt, device=device),
        w_b=dense_init(gen, (cfg.d_model, g * n), dt, device=device),
        w_c=dense_init(gen, (cfg.d_model, g * n), dt, device=device),
        w_dt=dense_init(gen, (cfg.d_model, h), dt, device=device),
        conv_x=dense_init(gen, (s.conv_width, di), dt, 0.3, device=device),
        conv_x_b=torch.zeros((di,), dtype=dt, device=dev),
        conv_bc=dense_init(gen, (s.conv_width, 2 * g * n), dt, 0.3,
                           device=device),
        conv_bc_b=torch.zeros((2 * g * n,), dtype=dt, device=dev),
        a_log=torch.log(a_init).to(f32),
        dt_bias=torch.log(torch.expm1(dt_init)).to(f32),
        d_skip=torch.ones((h,), dtype=f32, device=dev),
        norm_scale=torch.ones((di,), dtype=dt, device=dev),
        w_out=dense_init(gen, (di, cfg.d_model), dt, device=device))


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds (width small & static).
    x: (B, T, C); w: (W, C); b: (C,)."""
    width = w.shape[0]
    t = x.shape[1]
    out = x * w[width - 1][None, None, :].to(x.dtype)
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :t]
        out = out + shifted * w[width - 1 - i][None, None, :].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def ssm_forward(p: SSMParams, x, cfg: ModelConfig,
                return_state: bool = False):
    """Chunked SSD forward. x: (B, T, D) -> (B, T, D), with the decode
    state after the last position when ``return_state``."""
    scfg = cfg.ssm
    di, h, g, n, pp = _dims(cfg)
    hg = h // g
    b, t, _ = x.shape
    q = min(scfg.chunk, t)
    t_pad = -(-t // q) * q
    nc = t_pad // q
    f32 = torch.float32

    dtc = x.dtype
    z = x @ p.w_z.to(dtc)
    xs_raw = x @ p.w_x.to(dtc)
    bc_raw = torch.cat([x @ p.w_b.to(dtc), x @ p.w_c.to(dtc)], dim=-1)
    dt_raw = x @ p.w_dt.to(dtc)

    xs = _causal_conv(xs_raw, p.conv_x, p.conv_x_b)
    bc = _causal_conv(bc_raw, p.conv_bc, p.conv_bc_b)
    bs, cs = bc[..., :g * n], bc[..., g * n:]

    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None, :])  # (B, T, H)
    a = -torch.exp(p.a_log)                                     # (H,)

    if t_pad != t:
        # zero-pad to a chunk multiple; dt=0 at pad positions makes the
        # state update an exact identity there (decay 1, contribution 0)
        xs, bs, cs, dt = (F.pad(arr, (0, 0, 0, t_pad - t))
                          for arr in (xs, bs, cs, dt))

    xs_c = xs.reshape(b, nc, q, g, hg, pp)
    bs_c = bs.reshape(b, nc, q, g, n)
    cs_c = cs.reshape(b, nc, q, g, n)
    dt_c = dt.reshape(b, nc, q, g, hg)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    a_g = a.reshape(g, hg)[None, None]

    s_prev = torch.zeros((b, g, hg, pp, n), dtype=f32, device=x.device)
    y_chunks = []
    for ci in range(nc):
        x_k = xs_c[:, ci].float()                 # (B,Q,G,HG,P)
        b_k = bs_c[:, ci].float()                 # (B,Q,G,N)
        c_k = cs_c[:, ci].float()
        d_k = dt_c[:, ci]                         # (B,Q,G,HG)
        la = d_k * a_g                            # log-decay
        cum = torch.cumsum(la, dim=1)
        # intra: scores[i,j] = (C_i·B_j)·exp(cum_i − cum_j)·dt_j, j<=i
        cb = torch.einsum("bign,bjgn->bijg", c_k, b_k)         # (B,Q,Q,G)
        li = cum[:, :, None] - cum[:, None]                    # (B,Q,Q,G,HG)
        decay = torch.where(mask[None, :, :, None, None], torch.exp(li), 0.0)
        w_ij = cb[..., None] * decay * d_k[:, None]            # dt_j, axis 2
        y_intra = torch.einsum("bijgh,bjghp->bighp", w_ij, x_k)
        # inter: y_i += exp(cum_i)·(C_i · S_prev)
        y_inter = torch.einsum("bign,bghpn->bighp", c_k, s_prev) \
            * torch.exp(cum)[..., None]
        # state: S_new = exp(cum_Q)·S_prev + Σ_j exp(cum_Q−cum_j)·dt_j·B_j⊗x_j
        dec_end = torch.exp(cum[:, -1:] - cum)                 # (B,Q,G,HG)
        # the weights fold into x first: a three-operand einsum contracted
        # left to right would build a (B,Q,G,N,HG,P) product
        s_loc = torch.einsum("bjgn,bjghp->bghpn", b_k,
                             x_k * (d_k * dec_end)[..., None])
        s_prev = s_prev * torch.exp(cum[:, -1])[..., None, None] + s_loc
        y_chunks.append((y_intra + y_inter).to(dtc))
    y = torch.cat(y_chunks, dim=1)[:, :t].float()
    y = y + xs[:, :t].reshape(b, t, g, hg, pp).float() \
        * p.d_skip.reshape(g, hg)[None, None, :, :, None]
    y = y.reshape(b, t, di).to(dtc)

    y = rms_norm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = y @ p.w_out.to(dtc)
    if return_state:
        w = p.conv_x.shape[0]

        def tail(arr):
            if t >= w - 1:
                return arr[:, t - (w - 1):].clone()
            return F.pad(arr, (0, 0, w - 1 - t, 0))

        state = SSMState(s=s_prev, conv_x=tail(xs_raw), conv_bc=tail(bc_raw),
                         pos=torch.tensor(t, dtype=torch.int32,
                                          device=x.device))
        return out, state
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMState:
    scfg = cfg.ssm
    di, h, g, n, pp = _dims(cfg)
    return SSMState(
        s=torch.zeros((batch, g, h // g, pp, n), dtype=torch.float32,
                      device=device),
        conv_x=torch.zeros((batch, scfg.conv_width - 1, di), dtype=dtype,
                           device=device),
        conv_bc=torch.zeros((batch, scfg.conv_width - 1, 2 * g * n),
                            dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def ssm_decode(p: SSMParams, x, state: SSMState, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D) -> (out (B,1,D), state), the state
    updated in place."""
    di, h, g, n, pp = _dims(cfg)
    hg = h // g
    b = x.shape[0]
    dtc = x.dtype
    f32 = torch.float32
    xt = x[:, 0]
    z = xt @ p.w_z.to(dtc)
    xs_raw = xt @ p.w_x.to(dtc)
    bc_raw = torch.cat([xt @ p.w_b.to(dtc), xt @ p.w_c.to(dtc)], dim=-1)
    dt_raw = xt @ p.w_dt.to(dtc)

    def ring_conv(ring, new, w, bias):
        win = torch.cat([ring, new[:, None]], dim=1)            # (B, W, C)
        out = torch.einsum("bwc,wc->bc", win.float(), w.float())
        return F.silu(out + bias.float()).to(dtc), win[:, 1:]

    xs, new_cx = ring_conv(state.conv_x, xs_raw, p.conv_x, p.conv_x_b)
    bc, new_cbc = ring_conv(state.conv_bc, bc_raw, p.conv_bc, p.conv_bc_b)
    bs = bc[..., :g * n].reshape(b, g, n).float()
    cs = bc[..., g * n:].reshape(b, g, n).float()
    xh = xs.reshape(b, g, hg, pp).float()
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, :]).reshape(b, g, hg)
    a = -torch.exp(p.a_log).reshape(g, hg)

    decay = torch.exp(dt * a[None])                            # (B,G,HG)
    s_new = state.s * decay[..., None, None] + torch.einsum(
        "bgn,bghp,bgh->bghpn", bs, xh, dt)
    y = torch.einsum("bgn,bghpn->bghp", cs, s_new) \
        + xh * p.d_skip.reshape(g, hg)[None, :, :, None]
    y = y.reshape(b, 1, di).to(dtc)
    y = rms_norm(y * F.silu(z[:, None]), p.norm_scale, cfg.norm_eps)
    out = y @ p.w_out.to(dtc)
    state.s.copy_(s_new)
    state.conv_x.copy_(new_cx)
    state.conv_bc.copy_(new_cbc)
    state.pos.add_(1)
    return out, state
