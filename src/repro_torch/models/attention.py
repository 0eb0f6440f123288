"""GQA attention: RoPE, optional QKV bias, sliding window, blockwise
(flash-style) prefill for long sequences, KV-cache decode.
Counterpart of ``repro.models.attention``, in plain PyTorch ops (not
``scaled_dot_product_attention``): the blockwise pass keeps the JAX
package's chunk order, its masked-chunk arithmetic and its ``-1e30`` mask.

Layouts: activations (B, S, D); q (B, S, Hq, Dh); k/v (B, T, Hkv, Dh).
GQA is expressed with an explicit group dim in einsums (no repeat_kv
materialization).

Scales follow the JAX package's dtypes: the full and blockwise paths
multiply by a float32 ``1/sqrt(dh)``, which widens bfloat16 scores to
float32 before the scale; decode divides by ``sqrt(dh)`` in the scores'
own dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models import common
from repro_torch.models.common import (ModelConfig, ParamGroup, cdtype,
                                       dense_init, pdtype, rotary_embed)

NEG_INF = -1e30


class AttnParams(ParamGroup):
    """wq (D, Hq*Dh), wk/wv (D, Hkv*Dh), wo (Hq*Dh, D); biases bq/bk/bv or
    None."""
    FIELDS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def init_attn(gen, cfg: ModelConfig, device=None) -> AttnParams:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = pdtype(cfg)
    dev = gen.device if gen is not None else device

    def bias(n):
        return torch.zeros((n,), dtype=dt, device=dev) if cfg.qkv_bias \
            else None

    return AttnParams(
        wq=dense_init(gen, (d, hq * dh), dt, device=device),
        wk=dense_init(gen, (d, hkv * dh), dt, device=device),
        wv=dense_init(gen, (d, hkv * dh), dt, device=device),
        wo=dense_init(gen, (hq * dh, d), dt, device=device),
        bq=bias(hq * dh), bk=bias(hkv * dh), bv=bias(hkv * dh))


def _project_qkv(p: AttnParams, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = cdtype(cfg)
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if p.bq is not None:
        q, k, v = q + p.bq.to(dt), k + p.bk.to(dt), v + p.bv.to(dt)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    return q, k, v


def _causal_window_mask(s, t, q_offset, window, device):
    """(S, T) additive mask: causal + optional sliding window."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def full_attention(q, k, v, cfg: ModelConfig, q_offset=0):
    """Materialized-scores attention (short sequences)."""
    b, s, hq, dh = q.shape
    t = k.shape[1]
    g = hq // cfg.n_kv
    qg = q.reshape(b, s, cfg.n_kv, g, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    scores = scores + _causal_window_mask(s, t, q_offset, cfg.window,
                                          q.device)[None, None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq, dh)


def blockwise_attention(q, k, v, cfg: ModelConfig, q_offset=0):
    """Flash-style two-level blocking: the (S × T) score matrix is never
    materialized; a loop over KV chunks carries running (max, sum, acc)
    per query chunk. Causally-dead KV chunks still run, fully masked, as
    in the JAX package's shape-static scan.
    """
    b, s, hq, dh = q.shape
    t = k.shape[1]
    g = hq // cfg.n_kv
    cq, ckv = min(cfg.attn_chunk_q, s), min(cfg.attn_chunk_kv, t)
    assert s % cq == 0 and t % ckv == 0
    nq, nkv = s // cq, t // ckv
    scale = 1.0 / math.sqrt(dh)
    f32, dev = torch.float32, q.device

    qg = q.reshape(b, nq, cq, cfg.n_kv, g, dh)
    kc = k.reshape(b, nkv, ckv, cfg.n_kv, dh)
    vc = v.reshape(b, nkv, ckv, cfg.n_kv, dh)
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi]
        m = torch.full((b, cfg.n_kv, g, cq), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, cfg.n_kv, g, cq), dtype=f32, device=dev)
        acc = torch.zeros((b, cfg.n_kv, g, cq, dh), dtype=f32, device=dev)
        qpos = qi * cq + torch.arange(cq, device=dev)[:, None] + q_offset
        for ki in range(nkv):
            k_blk, v_blk = kc[:, ki], vc[:, ki]
            sc = torch.einsum("bskgd,btkd->bkgst", q_blk, k_blk).float() \
                * scale
            kpos = ki * ckv + torch.arange(ckv, device=dev)[None, :]
            ok = kpos <= qpos
            if cfg.window > 0:
                ok &= kpos > qpos - cfg.window
            sc = sc + torch.where(ok, 0.0, NEG_INF).to(f32)[None, None, None]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(q.dtype), v_blk).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (b,cq,kv,g,dh)
    return torch.cat(outs, dim=1).reshape(b, s, hq, dh)


class KVCache(NamedTuple):
    """A layer's cache; decode updates its tensors in place."""
    k: torch.Tensor     # (B, T, Hkv, Dh) — T = window size when windowed
    v: torch.Tensor
    pos: torch.Tensor   # () int32 — absolute next position, on the device


def init_kv_cache(cfg: ModelConfig, batch: int, max_t: int, dtype,
                  device=None) -> KVCache:
    t = min(max_t, cfg.window) if cfg.window > 0 else max_t
    shape = (batch, t, cfg.n_kv, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def _sp_decode_core(cfg: ModelConfig, q, k_new, v_new, cache: KVCache,
                    n_shards: int):
    """Split-K (flash-decoding) path: the KV sequence split into
    ``n_shards`` slices over the mesh's 'model' axis, each a ``narrow``
    view of the cache; the owner's slice takes the new token, every slice
    its partial softmax, and the logsumexp merge combines them
    (``serve.sp_attention``). Returns (B, 1, Hq, Dh)."""
    # imported here: the repro_torch.serve package imports the models
    from repro_torch.serve import sp_attention as SP
    t_shard = cache.k.shape[1] // n_shards
    k_shards = [cache.k.narrow(1, s * t_shard, t_shard)
                for s in range(n_shards)]
    v_shards = [cache.v.narrow(1, s * t_shard, t_shard)
                for s in range(n_shards)]
    for s in range(n_shards):
        SP.sp_cache_update(k_shards[s], v_shards[s], k_new, v_new,
                           cache.pos, s)
    return SP.sp_decode_attention(q, k_shards, v_shards, cache.pos,
                                  cfg.n_kv)


def _sp_shards(cfg: ModelConfig, cache: KVCache) -> int:
    """The split-K shard count: the installed mesh's 'model' axis when
    ``cfg.sp_decode`` is on, the cache is not a sliding-window ring and
    the axis divides its length; 0 (the plain path) otherwise."""
    if not cfg.sp_decode or cfg.window != 0:
        return 0
    mesh = common._ACT_CTX["mesh"]
    if mesh is None or "model" not in mesh.axis_names \
            or cache.k.shape[1] % mesh.shape["model"]:
        return 0
    return mesh.shape["model"]


def decode_attention(p: AttnParams, x, cache: KVCache, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D). Returns (out (B,1,D), cache), the
    cache updated in place: the new token's k/v written at its slot and
    ``pos`` advanced, with no host sync.

    Sliding-window caches are ring buffers indexed by pos % window; a full
    cache clamps the slot to its last row, as the JAX package's
    ``dynamic_update_slice`` does. With ``cfg.sp_decode`` under an
    installed mesh (``common.set_activation_sharding``) whose 'model' axis
    divides a full cache's length, the split-K path
    (:func:`_sp_decode_core`) runs instead."""
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = hq // hkv
    pos = cache.pos
    positions = pos.expand(b, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)

    n_shards = _sp_shards(cfg, cache)
    if n_shards:
        out = _sp_decode_core(cfg, q, k_new, v_new, cache, n_shards)
        out = out.reshape(b, 1, hq * dh) @ p.wo.to(x.dtype)
        pos.add_(1)
        return out, cache

    t_cache = cache.k.shape[1]
    slot = pos % t_cache if cfg.window > 0 else pos.clamp(max=t_cache - 1)
    slot = slot.view(1).long()
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))

    # validity of cache slots (absolute position per slot)
    slots = torch.arange(t_cache, device=x.device)
    if cfg.window > 0:
        # ring: slot holds absolute position p where p % t_cache == slot and
        # p <= pos and p > pos - t_cache
        abs_pos = pos - ((pos - slots) % t_cache)
        valid = (abs_pos >= 0) & (abs_pos <= pos) & \
            (abs_pos > pos - cfg.window)
    else:
        valid = slots <= pos

    qg = q.reshape(b, 1, hkv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, cache.k) / math.sqrt(dh)
    scores = scores.float() + torch.where(valid, 0.0, NEG_INF).to(
        torch.float32)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cache.v) \
        .reshape(b, 1, hq * dh)
    out = out @ p.wo.to(x.dtype)
    pos.add_(1)
    return out, cache


def attention_forward(p: AttnParams, x, cfg: ModelConfig, positions=None,
                      cache: Optional[KVCache] = None):
    """Training / prefill forward. x: (B, S, D). If a cache is given, it is
    filled in place (the ring-aligned last ``window`` positions when the
    prompt reaches past a sliding window) and returned."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if s > cfg.attn_chunk_threshold:
        out = blockwise_attention(q, k, v, cfg)
    else:
        out = full_attention(q, k, v, cfg)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo.to(x.dtype)
    if cache is not None:
        t_cache = cache.k.shape[1]
        if cfg.window > 0 and s >= t_cache:
            # keep the last `window` positions, ring-aligned
            shift = s % t_cache
            cache.k.copy_(torch.roll(k[:, -t_cache:], shifts=shift, dims=1))
            cache.v.copy_(torch.roll(v[:, -t_cache:], shifts=shift, dims=1))
        else:
            n = min(s, t_cache)
            cache.k.zero_()[:, :n] = k[:, :n]
            cache.v.zero_()[:, :n] = v[:, :n]
        cache.pos.fill_(s)
    return out, cache
