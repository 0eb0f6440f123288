"""Weights and caches carried across from the JAX package as numpy.

``repro.models.lm.init_lm`` returns ``{"embed", "final_norm", "lm_head"
(untied only), "segments"}``, where ``segments[i]`` is a tuple over the
period's blocks of dicts (``ln1``, ``attn``/``ssm``, ``ln2``, ``mlp``,
``moe``) whose leaves are stacked under a leading ``repeat`` dim, the layer
parts being ``NamedTuple``s (``None`` for absent biases). Pass it through
``jax.tree_util.tree_map(np.asarray, params)`` and into
:func:`lm_from_numpy`; :func:`lm_to_numpy` goes the other way. Its decode
caches (``lm_prefill``/``init_caches``) have the same
segment/period/``repeat`` layout.

:func:`to_repro_tree` and :func:`from_repro_tree` map any leaves keyed by
the port's parameter names (gradients, optimizer moments) to and from that
layout, so a training state is laid out as the JAX package's.
"""
from __future__ import annotations

import collections

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
from repro_torch.utils.tree import tree_map

_GROUPS = {"attn": A.AttnParams, "ssm": S.SSMParams, "mlp": M.MLPParams,
           "moe": MOE.MoEParams}
_CACHES = {"attn": A.KVCache, "ssm": S.SSMState}
# the JAX package's NamedTuple of each layer part, by its field names
_TUPLES = {name: collections.namedtuple(cls.__name__, cls.FIELDS)
           for name, cls in _GROUPS.items()}


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


def caches_to_repro_tree(cfg: ModelConfig, caches: list) -> list:
    """The port's caches in the JAX package's stacked layout, tensors kept
    (``meta`` ones too): ``out[i][j][name]`` is the cache ``NamedTuple``
    with a leading ``repeat`` dim on every field."""
    out = []
    for i, (repeat, period) in enumerate(cfg.segments):
        seg = []
        for j in range(len(period)):
            entry = {}
            for name in caches[i][0][j]:
                cls = _CACHES[name]
                entry[name] = cls(*(torch.stack([getattr(
                    caches[i][r][j][name], f) for r in range(repeat)])
                    for f in cls._fields))
            seg.append(entry)
        out.append(tuple(seg))
    return out


def caches_to_numpy(cfg: ModelConfig, caches: list) -> list:
    """:func:`caches_to_repro_tree` as numpy."""
    return tree_map(to_numpy, caches_to_repro_tree(cfg, caches))


def _parts(kind: str) -> tuple:
    """The layer parts a block kind holds, as ``blocks.init_block``."""
    parts = ("attn",) if kind in blocks.ATTN_KINDS else ("ssm",)
    if kind in ("attn_mlp", "mamba_mlp", "arctic"):
        parts += ("mlp",)
    if kind in ("attn_moe", "mamba_moe", "arctic"):
        parts += ("moe",)
    return parts


def _stack(xs: list):
    """Leaves of one segment's layers stacked under a leading ``repeat``
    dim: tensors, arrays, or ``NamedTuple`` leaves with ``tree_aux``
    fields (``train.optim.Q8``), whose array fields stack field by field
    (exact for Q8: its blocks run along the last dim)."""
    x0 = xs[0]
    aux = getattr(type(x0), "tree_aux", None)
    if aux is not None:
        return type(x0)(**{f: getattr(x0, f) if f in aux
                           else _stack([getattr(x, f) for x in xs])
                           for f in x0._fields})
    if isinstance(x0, torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def _take(x, r: int):
    """Row ``r`` of a stacked leaf (the inverse of :func:`_stack`)."""
    aux = getattr(type(x), "tree_aux", None)
    if aux is not None:
        return type(x)(**{f: getattr(x, f) if f in aux
                          else getattr(x, f)[r] for f in x._fields})
    return x[r]


def to_repro_tree(cfg: ModelConfig, named: dict) -> dict:
    """Leaves keyed by the port's parameter names (``named_parameters()``
    of a :class:`TransformerLM`) in the JAX package's params layout."""
    out = {"embed": named["embed"], "final_norm": named["final_norm"],
           "segments": []}
    if "lm_head" in named:
        out["lm_head"] = named["lm_head"]
    for i, (repeat, period) in enumerate(cfg.segments):
        seg = []
        for j, kind in enumerate(period):
            def stacked(suffix, i=i, j=j, repeat=repeat):
                if f"segments.{i}.0.{j}.{suffix}" not in named:
                    return None
                return _stack([named[f"segments.{i}.{r}.{j}.{suffix}"]
                               for r in range(repeat)])

            block = {"ln1": stacked("ln1")}
            parts = _parts(kind)
            if len(parts) > 1:
                block["ln2"] = stacked("ln2")
            for name in parts:
                block[name] = _TUPLES[name](**{
                    f: stacked(f"{name}.{f}") for f in _GROUPS[name].FIELDS})
            seg.append(block)
        out["segments"].append(tuple(seg))
    return out


def param_shapes(cfg: ModelConfig, model: TransformerLM) -> dict:
    """``model``'s parameters as ``meta`` tensors (shapes and dtypes only)
    in the JAX package's params layout: the tree the sharding rules
    (``launch.shardings``) read."""
    return to_repro_tree(cfg, {
        n: torch.empty(p.shape, dtype=p.dtype, device="meta")
        for n, p in model.named_parameters()})


def from_repro_tree(cfg: ModelConfig, tree: dict) -> dict:
    """The inverse of :func:`to_repro_tree`: the JAX package's layout to
    leaves keyed by the port's parameter names (``None`` leaves left
    out)."""
    named = {k: tree[k] for k in ("embed", "final_norm", "lm_head")
             if tree.get(k) is not None}
    for i, (repeat, period) in enumerate(cfg.segments):
        for j, kind in enumerate(period):
            block = tree["segments"][i][j]
            leaves = {"ln1": block["ln1"], "ln2": block.get("ln2")}
            for name in _parts(kind):
                for f in _GROUPS[name].FIELDS:
                    leaves[f"{name}.{f}"] = getattr(block[name], f)
            for suffix, leaf in leaves.items():
                if leaf is None:
                    continue
                for r in range(repeat):
                    named[f"segments.{i}.{r}.{j}.{suffix}"] = _take(leaf, r)
    return named


def lm_to_numpy(model: TransformerLM, cfg: ModelConfig) -> dict:
    """A :class:`TransformerLM`'s weights as numpy in the JAX package's
    ``init_lm`` tree: segments stacked under ``repeat``, ``NamedTuple``
    layer parts, ``None`` for absent biases."""
    return to_repro_tree(cfg, {name: to_numpy(p) for name, p
                               in model.named_parameters()})
