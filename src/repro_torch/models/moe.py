"""Mixture-of-experts FFN: top-k routing, GShard-style capacity dispatch.
Counterpart of ``repro.models.moe``.

Tokens are processed in fixed-size groups (a loop over sequence chunks
bounds the (B, S, E, C) dispatch tensor); within each group, dispatch and
combine einsums move tokens to per-expert capacity slots. Expert weights
carry an explicit leading E dim.

Routing follows the JAX package bit for bit: the router product
accumulates in float32, top-k takes the lower expert index first on ties
(a stable descending sort, as ``lax.top_k``), and capacity slots go
slot-major, then in token order, so the same assignments drop.

Aux losses: load-balancing (Switch) + router z-loss, returned to the caller.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import (ModelConfig, MoEConfig, ParamGroup,
                                       constrain_dims, dense_init, pdtype)


class MoEParams(ParamGroup):
    """w_router (D, E) float32; w_gate/w_up (E, D, F); w_down (E, F, D)."""
    FIELDS = ("w_router", "w_gate", "w_up", "w_down")


def init_moe(gen, cfg: ModelConfig, device=None) -> MoEParams:
    assert cfg.moe is not None
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    dt = pdtype(cfg)
    return MoEParams(
        w_router=dense_init(gen, (d, e), torch.float32, device=device),
        w_gate=dense_init(gen, (e, d, f), dt, device=device),
        w_up=dense_init(gen, (e, d, f), dt, device=device),
        w_down=dense_init(gen, (e, f, d), dt, device=device))


def _capacity(mcfg: MoEConfig, group: int) -> int:
    c = int(group * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts)
    return max(4, -(-c // 4) * 4)


def _f_split(e: int, f: int) -> int:
    """Smallest s with (e·s) divisible by the installed mesh's model axis
    and f % s == 0: each expert's d_ff splits into s parts so the expert
    dim shards over that axis.

    Gated off by default, as in the JAX package (splitting inside the
    layer re-shards the expert weights on every layer there); set
    ``REPRO_MOE_FSPLIT=1`` to turn it on. A split gives the same layer
    output (gated FFNs are elementwise in d_ff)."""
    if not os.environ.get("REPRO_MOE_FSPLIT"):
        return 1
    mesh = common._ACT_CTX["mesh"]
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    mp = mesh.shape["model"]
    if e % mp == 0:
        return 1
    for s in range(2, mp + 1):
        if (e * s) % mp == 0 and f % s == 0:
            return s
    return 1


def _route(p: MoEParams, x, mcfg: MoEConfig, c: int):
    """Routing of one group. x: (B, S, D). Returns (logits, probs,
    gate_vals, idx, oh, within, pos_c): float32 router logits and probs
    (B, S, E); normalised gates and expert ids (B, S, k); the one-hot
    assignments (B, S, k, E); ``within`` marks the kept ones and ``pos_c``
    their capacity slot (0 where dropped)."""
    b, s, _ = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    # float32 accumulation of the router product from inputs in their dtype
    logits = x.float() @ p.w_router.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :k], idx[..., :k]          # (B, S, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # per-slot one-hot and capacity positions (priority: slot-major, then
    # token order)
    oh = F.one_hot(idx, e).to(torch.int32)                     # (B, S, k, E)
    prio = oh.permute(2, 0, 1, 3).reshape(k * b * s, e)
    pos_prio = torch.cumsum(prio, dim=0) - prio
    pos = pos_prio.reshape(k, b, s, e).permute(1, 2, 0, 3)     # (B, S, k, E)
    within = (pos < c) & (oh > 0)
    pos_c = torch.where(within, pos, 0)
    return logits, probs, gate_vals, idx, oh, within, pos_c


def _group_moe(p: MoEParams, x, mcfg: MoEConfig, compute_dtype):
    """One dispatch group. x: (B, S, D) -> (out (B, S, D), aux dict)."""
    b, s, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    c = _capacity(mcfg, b * s)
    logits, probs, gate_vals, idx, oh, within, pos_c = _route(p, x, mcfg, c)

    # dispatch[b,s,e,c] = Σ_k within·onehot(pos_c) and combine the same
    # weighted by the gate: a token's top-k experts are distinct, so at
    # most one k is nonzero per (b, s, e) and a scatter of that one term
    # gives the JAX package's sums exactly, without the (B,S,k,E,C) tensor
    w = within.to(compute_dtype)
    slot = (pos_c * within).sum(2)[..., None].long()           # (B, S, E, 1)
    dispatch = torch.zeros((b, s, e, c), dtype=compute_dtype,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    dispatch.scatter_(3, slot, w.sum(2)[..., None])
    combine.scatter_(3, slot, (w * gate_vals[..., None].to(compute_dtype))
                     .sum(2)[..., None])
    dispatch = constrain_dims(dispatch, "dp", None, None, None)

    # expert f-splitting (exact for gated FFNs: f is elementwise in
    # gate/up, summed in down)
    split = _f_split(e, p.w_gate.shape[-1])
    wg, wu, wd = p.w_gate, p.w_up, p.w_down
    if split > 1:
        e2, f2 = e * split, p.w_gate.shape[-1] // split
        d_model = wg.shape[1]
        wg = wg.reshape(e, d_model, split, f2).permute(0, 2, 1, 3) \
            .reshape(e2, d_model, f2)
        wu = wu.reshape(e, d_model, split, f2).permute(0, 2, 1, 3) \
            .reshape(e2, d_model, f2)
        wd = wd.reshape(e, split, f2, d_model).reshape(e2, f2, d_model)
        dispatch = torch.repeat_interleave(dispatch, split, dim=2)
        combine = torch.repeat_interleave(combine, split, dim=2)

    xin = torch.einsum("bsec,bsd->ecd", dispatch, x.to(compute_dtype))
    xin = constrain_dims(xin, "mp", "dp", None)             # EP × capacity-DP
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, wg.to(compute_dtype))) \
        * torch.einsum("ecd,edf->ecf", xin, wu.to(compute_dtype))
    hout = torch.einsum("ecf,efd->ecd", h, wd.to(compute_dtype))
    hout = constrain_dims(hout, "mp", "dp", None)
    out = torch.einsum("bsec,ecd->bsd", combine, hout)
    out = constrain_dims(out, "dp", None, None)

    # aux: load-balance (mean prob * mean assignment) + z-loss
    me = probs.reshape(-1, e).mean(0)                          # (E,)
    ce = oh.reshape(-1, e).float().mean(0) * e / k
    lb = torch.sum(me * ce) * e
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - within.float().sum() / (b * s * k)
    return out.to(x.dtype), {"lb_loss": lb, "z_loss": z,
                             "drop_frac": dropped}


def moe_forward(p: MoEParams, x, cfg: ModelConfig):
    """x: (B, S, D) -> (out, aux).

    The sequence dim is chunked (bounds dispatch memory); the batch dim
    stays intact, and the aux losses are the chunks' means."""
    mcfg = cfg.moe
    b, s, d = x.shape
    s_c = max(1, min(s, mcfg.group_size // max(b, 1)))
    while s % s_c:
        s_c -= 1
    n_chunks = s // s_c
    compute_dtype = x.dtype

    if n_chunks == 1:
        return _group_moe(p, x, mcfg, compute_dtype)

    outs, auxs = [], []
    for i in range(n_chunks):
        out, aux = _group_moe(p, x[:, i * s_c:(i + 1) * s_c], mcfg,
                              compute_dtype)
        outs.append(out)
        auxs.append(aux)
    aux = {name: torch.stack([a[name] for a in auxs]).mean()
           for name in ("lb_loss", "z_loss", "drop_frac")}
    return torch.cat(outs, dim=1), aux
