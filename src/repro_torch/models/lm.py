"""TransformerLM: a decoder of heterogeneous layer periods, with prefill and
KV-cache decode. Counterpart of ``repro.models.lm``.

Layers are organized as ``cfg.segments = ((repeat, (kind, ...)), ...)``:
homogeneous models are one segment of a 1-kind period; hybrids (jamba)
repeat a multi-kind period. The JAX package stacks each segment's layers
under a leading ``repeat`` dim and scans over it; the port keeps one
:class:`~repro_torch.models.blocks.Block` per layer, at
``lm.segments[i][r][j]`` (segment, repeat, position in the period), and
loops.

Frontends: ``audio`` consumes precomputed frame embeddings; ``vision``
prepends precomputed patch embeddings to the token embeddings.

The module-level functions keep the JAX package's names and arguments, with
a :class:`TransformerLM` where it takes the params tree. Parameters are
built taking no gradient, for the serving path; the trainer
(``repro_torch.train``) turns gradients on with ``requires_grad_(True)``.
With ``cfg.remat``, while gradients are recorded for the parameters, each
block's forward is recomputed in the backward pass
(``torch.utils.checkpoint``), the counterpart of the JAX package's
``jax.checkpoint`` around its scan body.
"""
from __future__ import annotations

import copy

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, cdtype, dense_init,
                                       frozen, pdtype, rms_norm,
                                       shard_batch_dim)
from repro_torch.models.ssm import SSMParams


class TransformerLM(nn.Module):
    """The LM's parameters (``embed``, ``final_norm``, ``lm_head`` or None
    when tied, ``segments``) and its config; calling it runs
    :func:`lm_forward`."""

    def __init__(self, cfg: ModelConfig, embed, final_norm, lm_head,
                 segments):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen(embed)
        self.final_norm = frozen(final_norm)
        self.lm_head = frozen(lm_head)
        self.segments = nn.ModuleList(
            nn.ModuleList(nn.ModuleList(layer) for layer in seg)
            for seg in segments)

    def forward(self, batch: dict):
        return lm_forward(self, self.cfg, batch)

    def layers(self):
        """(kind, Block) of every layer in order."""
        for seg in self.segments:
            for layer in seg:
                for block in layer:
                    yield block.kind, block


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> TransformerLM:
    """Random weights drawn from a ``torch.Generator`` seeded by ``seed`` on
    ``device`` (the card unless the caller asks for the CPU; ``"meta"``
    gives shapes only). The draws are not the JAX package's: carry its
    weights across with :func:`~repro_torch.models.convert.lm_from_numpy`."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    dt = pdtype(cfg)
    embed = dense_init(gen, (cfg.vocab, cfg.d_model), dt, device=dev)
    final_norm = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    head = None if cfg.tie_embeddings else \
        dense_init(gen, (cfg.d_model, cfg.vocab), dt, device=dev)
    segments = [[[blocks.init_block(gen, kind, cfg, dev) for kind in period]
                 for _ in range(repeat)]
                for repeat, period in cfg.segments]
    return TransformerLM(cfg, embed, final_norm, head, segments)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _embed_inputs(params: TransformerLM, cfg: ModelConfig, batch: dict):
    dt = cdtype(cfg)
    if cfg.frontend == "audio":
        return batch["frame_embeds"].to(dt)       # (B, S, D) stub frontend
    x = params.embed[batch["tokens"]].to(dt)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(dt), x], dim=1)
    return x


def _head(params: TransformerLM, cfg: ModelConfig, x):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    w_out = params.lm_head if params.lm_head is not None else params.embed.T
    return x @ w_out.to(x.dtype)


def lm_forward(params: TransformerLM, cfg: ModelConfig, batch: dict):
    """Full-sequence forward. Returns (logits (B,S,V), aux)."""
    x = _embed_inputs(params, cfg, batch)
    aux_total = blocks.zero_aux(x.device)
    # remat only while a backward pass is being recorded (the trainer
    # switches every parameter to take gradients)
    remat = cfg.remat and torch.is_grad_enabled() and \
        params.final_norm.requires_grad
    for kind, block in params.layers():
        if remat:
            x, a = checkpoint(blocks.block_forward, kind, block, x, cfg,
                              use_reentrant=False)
        else:
            x, a = blocks.block_forward(kind, block, x, cfg)
        x = shard_batch_dim(x)            # keep batch on the DP axes
        aux_total = blocks._add_aux(aux_total, a)
    return _head(params, cfg, x), aux_total


def lm_loss(params: TransformerLM, cfg: ModelConfig, batch: dict,
            lb_weight: float = 0.01, z_weight: float = 1e-3):
    """Cross-entropy (+ MoE aux) loss. batch: tokens/targets/(mask)."""
    logits, aux = lm_forward(params, cfg, batch)
    targets = batch["targets"]
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        # loss only over the text region (prefix positions carry no targets)
        prefix = batch["patch_embeds"].shape[1]
        logits = logits[:, prefix:]
    logits32 = logits.float()
    # the max only shifts the exponent: no gradient through it
    m = torch.amax(logits32, dim=-1, keepdim=True).detach()
    logz = torch.log(torch.sum(torch.exp(logits32 - m), dim=-1)) + m[..., 0]
    # the gold logit in the logits' dtype (the JAX package's one-hot
    # contraction has one nonzero term: the same value)
    gold = logits.gather(-1, targets[..., None].long())[..., 0].float()
    nll = logz - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + lb_weight * aux["lb_loss"] + z_weight * aux["z_loss"]
    metrics = {"nll": loss, **aux}
    return total, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_t: int, dtype=None,
                device=None) -> list:
    """Zeroed decode caches, ``caches[i][r][j]`` as the layers."""
    dtype = dtype or cdtype(cfg)
    dev = resolve_device(device)
    return [[tuple(blocks.init_block_cache(k, cfg, batch, max_t, dtype, dev)
                   for k in period) for _ in range(repeat)]
            for repeat, period in cfg.segments]


def lm_prefill(params: TransformerLM, cfg: ModelConfig, batch: dict,
               max_t: int):
    """Process the prompt, build decode caches. Returns (logits of the last
    position (B, 1, V), caches)."""
    x = _embed_inputs(params, cfg, batch)
    dtype = cdtype(cfg)
    caches = []
    for seg in params.segments:
        seg_caches = []
        for layer in seg:
            cs = []
            for block in layer:
                x, _, c = blocks.block_prefill(block.kind, block, x, cfg,
                                               max_t, dtype)
                cs.append(c)
            seg_caches.append(tuple(cs))
        caches.append(seg_caches)
    return _head(params, cfg, x[:, -1:]), caches


def lm_decode_step(params: TransformerLM, caches: list, cfg: ModelConfig,
                   tokens):
    """One decode step. tokens: (B, 1) int. Returns (logits (B, 1, V),
    caches), the caches updated in place (where the JAX package threads
    them through its scan carry). ``cfg.decode_unroll`` changes nothing:
    the JAX package's two branches compute the same values."""
    x = params.embed[tokens].to(cdtype(cfg))
    for seg, seg_caches in zip(params.segments, caches):
        for layer, layer_caches in zip(seg, seg_caches):
            for block, cache in zip(layer, layer_caches):
                x, _ = blocks.block_decode(block.kind, block, x, cache, cfg)
    return _head(params, cfg, x), caches


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from shapes alone (built on the ``meta`` device)."""
    return sum(p.numel() for p in init_lm(cfg, device="meta").parameters())


# leaves the model reads in float32 whatever the compute dtype (the SSM's
# decay, step bias and skip) or, in decode, widens to float32 (its conv)
_KEEP_STORED = frozenset(SSMParams.FIELDS) - {
    "w_z", "w_x", "w_b", "w_c", "w_dt", "norm_scale", "w_out"}


def cast_for_compute(params: TransformerLM) -> TransformerLM:
    """A copy of ``params`` whose leaves are stored in the compute dtype
    wherever every use casts them to it, so each call reads them as they
    are: the same values as casting at every use. The SSM's float32 leaves
    and its conv (which decode widens to float32) keep their stored dtype;
    leaves already in the compute dtype are shared, not copied."""
    dt = cdtype(params.cfg)
    out = copy.deepcopy(params, {id(p): p for p in params.parameters()})
    for module in out.modules():
        keep = _KEEP_STORED if isinstance(module, SSMParams) else ()
        for name, p in list(module.named_parameters(recurse=False)):
            if name not in keep and p.dtype != dt:
                setattr(module, name, frozen(p.detach().to(dt)))
    return out
