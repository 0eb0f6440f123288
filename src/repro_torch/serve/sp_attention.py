"""Sequence-parallel (split-K / flash-decoding) decode attention.
Counterpart of ``repro.serve.sp_attention``.

For decode shapes the KV cache dominates memory, so its sequence dim
shards over the mesh's ``model`` axis. One softmax over a sharded axis is
written out: each shard computes a partial (max, sum-exp, weighted-V) over
its KV slice (:func:`sp_partial`), and a logsumexp merge combines them
(:func:`sp_merge`). ``repro`` merges with a ``pmax`` and two ``psum``s
inside ``shard_map``; a single controller holds every shard's partial, so
the ``pmax`` is a max over the shards and each ``psum`` a sum in shard
order.

The new token's K/V lands in its owner's slice only
(:func:`sp_cache_update`), in place and without reading ``pos`` to the
host. Shards are ``narrow`` views of one cache tensor where the mesh is
local (``attention._sp_decode_core``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def sp_partial(q, k_shard, v_shard, pos, n_kv: int, shard: int):
    """One shard's partial over its KV slice.

    q: (B, 1, Hq, Dh). k_shard/v_shard: (B, T_shard, Hkv, Dh), shard
    ``shard``'s slice (positions ``shard·T_shard`` onward). pos: () int32
    on the device, the current absolute position (k/v already updated).
    Returns float32 ``(m_loc (B,Hkv,G,1), s_loc (B,Hkv,G,1), o_loc
    (B,1,Hkv,G,Dh))``."""
    b, _, hq, dh = q.shape
    t_shard = k_shard.shape[1]
    g = hq // n_kv
    kpos = shard * t_shard + torch.arange(t_shard, device=q.device)
    valid = kpos <= pos                                     # (T_shard,)

    qg = q.reshape(b, 1, n_kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_shard) / math.sqrt(dh)
    scores = scores.float() + torch.where(valid, 0.0, NEG_INF).to(
        torch.float32)
    m_loc = scores.amax(dim=-1)                             # (B,Hkv,G,1)
    p = torch.exp(scores - m_loc[..., None])
    s_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v_shard) \
        .float()                                            # (B,1,Hkv,G,Dh)
    return m_loc, s_loc, o_loc


def sp_merge(partials, dtype) -> torch.Tensor:
    """The logsumexp merge of every shard's :func:`sp_partial`, in shard
    order. Returns (B, 1, Hq, Dh) in ``dtype``."""
    m_glob = partials[0][0]
    for m_loc, _, _ in partials[1:]:
        m_glob = torch.maximum(m_glob, m_loc)               # pmax
    s_glob = o_glob = None
    for m_loc, s_loc, o_loc in partials:
        alpha = torch.exp(m_loc - m_glob)                   # (B,Hkv,G,1)
        s_part = alpha * s_loc
        o_part = o_loc * alpha.permute(0, 3, 1, 2)[..., None]
        s_glob = s_part if s_glob is None else s_glob + s_part     # psum
        o_glob = o_part if o_glob is None else o_glob + o_part     # psum
    out = o_glob / torch.clamp(s_glob, min=1e-30).permute(0, 3, 1, 2)[
        ..., None]
    b, _, hkv, g, dh = out.shape
    return out.reshape(b, 1, hkv * g, dh).to(dtype)


def sp_decode_attention(q, k_shards, v_shards, pos, n_kv: int):
    """Split-K decode over the KV slices ``k_shards[s]``/``v_shards[s]``
    (shard s holds positions ``s·T_shard`` onward): the partials, then the
    merge. Returns (B, 1, Hq, Dh) in q's dtype."""
    return sp_merge([sp_partial(q, k, v, pos, n_kv, s)
                     for s, (k, v) in enumerate(zip(k_shards, v_shards))],
                    q.dtype)


def sp_cache_update(k_cache, v_cache, k_new, v_new, pos, shard: int):
    """Write the new token's K/V into shard ``shard``'s slice if it owns
    ``pos``, in place; a non-owner writes its slot 0 back unchanged (the
    JAX package's masked update), so no shard reads ``pos`` to the host.

    k_cache: (B, T_shard, Hkv, Dh), the shard's slice; k_new: (B, 1, Hkv,
    Dh). Returns the slices."""
    t_shard = k_cache.shape[1]
    owner = torch.div(pos, t_shard, rounding_mode="floor")
    is_mine = owner == shard
    slot = torch.where(is_mine, pos - owner * t_shard, 0).view(1).long()
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache.index_copy_(1, slot, torch.where(
            is_mine, new.to(cache.dtype), cache.index_select(1, slot)))
    return k_cache, v_cache


def reference_decode_attention(q, k, v, pos, n_kv: int):
    """Single-device oracle for the split-K path."""
    b, _, hq, dh = q.shape
    t = k.shape[1]
    g = hq // n_kv
    valid = torch.arange(t, device=q.device) <= pos
    qg = q.reshape(b, 1, n_kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(dh)
    scores = scores.float() + torch.where(valid, 0.0, NEG_INF).to(
        torch.float32)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, 1, hq, dh)
