"""Weights and caches carried across from the JAX package as numpy.

``repro.models.lm.init_lm`` returns ``{"embed", "final_norm", "lm_head"
(untied only), "segments"}``, where ``segments[i]`` is a tuple over the
period's blocks of dicts (``ln1``, ``attn``/``ssm``, ``ln2``, ``mlp``,
``moe``) whose leaves are stacked under a leading ``repeat`` dim, the layer
parts being ``NamedTuple``s (``None`` for absent biases). Pass it through
``jax.tree_util.tree_map(np.asarray, params)`` and into
:func:`lm_from_numpy`. Its decode caches (``lm_prefill``/``init_caches``)
have the same segment/period/``repeat`` layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import blocks
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import TransformerLM

_GROUPS = {"attn": A.AttnParams, "ssm": S.SSMParams, "mlp": M.MLPParams,
           "moe": MOE.MoEParams}
_CACHES = {"attn": A.KVCache, "ssm": S.SSMState}


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` too) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (bfloat16 widened to float32, exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _block(kind: str, tree: dict, r: int, device) -> blocks.Block:
    def leaf(a):
        return None if a is None else to_tensor(np.asarray(a)[r], device)

    parts = {name: cls(**{f: leaf(getattr(tree[name], f))
                          for f in cls.FIELDS})
             for name, cls in _GROUPS.items() if name in tree}
    return blocks.Block(kind, leaf(tree["ln1"]), ln2=leaf(tree.get("ln2")),
                        **parts)


def lm_from_numpy(cfg: ModelConfig, params: dict, device=None) \
        -> TransformerLM:
    """The JAX package's ``init_lm`` tree, as numpy, as a
    :class:`TransformerLM` on ``device`` (the card unless the caller asks
    for the CPU): each segment's ``repeat`` dim unstacked into layers."""
    dev = resolve_device(device)
    segments = [[[_block(kind, params["segments"][i][j], r, dev)
                  for j, kind in enumerate(period)]
                 for r in range(repeat)]
                for i, (repeat, period) in enumerate(cfg.segments)]
    head = params.get("lm_head")
    return TransformerLM(cfg, to_tensor(params["embed"], dev),
                         to_tensor(params["final_norm"], dev),
                         None if head is None else to_tensor(head, dev),
                         segments)


def caches_from_numpy(cfg: ModelConfig, caches: list, device=None) -> list:
    """The JAX package's stacked decode caches, as numpy, in the port's
    per-layer layout ``caches[i][r][j]``."""
    dev = resolve_device(device)
    out = []
    for i, (repeat, period) in enumerate(cfg.segments):
        out.append([tuple(
            {name: _CACHES[name](*(to_tensor(np.asarray(a)[r], dev)
                                   for a in leaf))
             for name, leaf in caches[i][j].items()}
            for j in range(len(period))) for r in range(repeat)])
    return out


def caches_to_numpy(cfg: ModelConfig, caches: list) -> list:
    """The port's caches in the JAX package's stacked layout, as numpy:
    ``out[i][j][name]`` is the cache ``NamedTuple`` with a leading
    ``repeat`` dim on every field."""
    out = []
    for i, (repeat, period) in enumerate(cfg.segments):
        seg = []
        for j in range(len(period)):
            entry = {}
            for name in caches[i][0][j]:
                cls = _CACHES[name]
                entry[name] = cls(*(np.stack([to_numpy(getattr(
                    caches[i][r][j][name], f)) for r in range(repeat)])
                    for f in cls._fields))
            seg.append(entry)
        out.append(tuple(seg))
    return out
