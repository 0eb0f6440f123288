"""An analytic H100 roofline for the port's steps. Counterpart of
``repro.launch.roofline``, which walks compiled HLO against a TPU v5e; the
port has no HLO, so it counts a step by running it:

* :func:`count_step` runs one step (on ``meta`` tensors: shapes only, no
  memory) under ``torch.utils.flop_counter.FlopCounterMode`` for its
  FLOPs and under a dispatch mode that sums each aten op's bytes;
* :func:`collective_bytes` reckons the collectives from the sharding
  specs (``launch.shardings``), since a single controller issues none;
* :func:`roofline_terms` turns per-card FLOPs, bytes and collective
  seconds into the three times and the bound.

Hardware constants, from NVIDIA's H100 SXM data sheet (dense rates, no
sparsity, at the 700 W limit).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.shardings import is_spec
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

BF16_FLOPS = 989e12           # dense bfloat16 tensor-core rate
F32_FLOPS = 67e12             # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
NVLINK_BYTES_PER_S = 450e9    # NVLink 4, per direction, inside a node
IB_BYTES_PER_S = 50e9         # NDR InfiniBand (400 Gb/s) per card
CARDS_PER_NODE = 8            # an HGX H100 node


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

# ops that read only the rows they gather (plus their indices), not the
# whole source tensor
_GATHERS = frozenset({"aten::index", "aten::index_select", "aten::gather",
                      "aten::embedding", "aten::take"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Sums the bytes each aten op reads and writes, as if every op read
    its inputs from and wrote its outputs to device memory once (no
    fusion). Views move nothing. A gather reads its indices and the rows
    it writes. An op that writes into an argument larger than its other
    inputs (``index_copy_``, ``scatter_``) writes as many bytes as its
    largest other input and reads nothing of that argument; any other
    in-place op reads and writes the argument whole."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        schema = func._schema
        written = [a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if not written and any(r.alias_info is not None
                               for r in schema.returns):
            return out                                   # a view
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        ins = [t for k, t in named.items()
               if k not in written and isinstance(t, torch.Tensor)]
        ins += [t for v in named.values() if isinstance(v, (list, tuple))
                for t in v if isinstance(t, torch.Tensor)]
        if schema.name in _GATHERS:
            outs = [t for t in _pytree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            src = named.get("self", named.get("weight"))
            idx = sum(_nbytes(t) for t in ins if t is not src)
            self.bytes += idx + 2 * sum(_nbytes(t) for t in outs)
            return out
        largest = max((_nbytes(t) for t in ins), default=0)
        self.bytes += sum(_nbytes(t) for t in ins)
        for name in written:
            t = named.get(name)
            if not isinstance(t, torch.Tensor):
                continue
            if 0 < largest < _nbytes(t):
                self.bytes += largest                # a scatter-like write
            else:
                self.bytes += 2 * _nbytes(t)         # read and write whole
        if not written:
            self.bytes += sum(_nbytes(t) for t in _pytree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def count_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once and count it: ``flops`` (matmuls,
    convolutions and attention, ``FlopCounterMode``'s count), ``bytes``
    (:class:`ByteCounter`), ``ops`` (aten calls) and ``saved_bytes``, the
    activations autograd saved for backward (each tensor once, parameters
    left out; under ``torch.utils.checkpoint`` the segments' inputs).
    Run it on ``meta`` tensors for shapes only. Returns the counts; the
    step's result is dropped."""
    saved = {}

    def pack(t):
        if not (t.is_leaf and t.requires_grad):
            saved[id(t)] = t
        return t

    with FlopCounterMode(display=False) as fc, ByteCounter() as bc, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return {"flops": float(fc.get_total_flops()), "bytes": float(bc.bytes),
            "ops": bc.ops,
            "saved_bytes": float(sum(_nbytes(t) for t in saved.values()))}


# ---------------------------------------------------------------------------
# collectives, from the specs
# ---------------------------------------------------------------------------

def _payload(nbytes: float, n: int) -> float:
    """Bytes a card moves in a ring collective over ``n`` cards on a
    tensor of ``nbytes`` (whole over that group): (n - 1) / n of it."""
    return nbytes * (n - 1) / n if n > 1 else 0.0


def _axes(spec) -> set:
    out = set()
    for a in spec:
        if a is not None:
            out.update(a if isinstance(a, tuple) else (a,))
    return out


def _add(coll: dict, op: str, axis: str, nbytes: float) -> None:
    if nbytes > 0:
        coll.setdefault(op, {})
        coll[op][axis] = coll[op].get(axis, 0.0) + nbytes


def collective_bytes(rules, specs: dict, shapes: dict, kind: str,
                     step: dict) -> dict:
    """Per-card payload bytes of one step's collectives, ``{op: {axis:
    bytes}}`` (op ``all-gather``, ``reduce-scatter`` or ``all-reduce``;
    axis a mesh axis name, or names joined by ``+``), reckoned from the
    specs. ``specs``/``shapes`` hold matching trees: ``"params"`` (in
    ``repro``'s layout, stacked leaves' first dim the layer count) and,
    for decode, ``"caches"`` (a list of segments as
    ``shardings.cache_specs``). ``kind`` is ``train``, ``prefill`` or
    ``decode``; ``step`` gives ``batch`` (global), ``seq``, ``act_bytes``
    (the compute dtype's), ``n_heads``, ``head_dim`` and, for train,
    ``microbatches`` (μ) and ``acc_bytes`` (the gradient accumulator's),
    for decode ``sp_decode``.

    A collective over n cards on a tensor of X bytes (whole over those n)
    moves (n - 1)/n · X per card, in a ring: the payload counted here;
    ``weighted_collective_bytes`` then doubles the all-reduces (a
    reduce-scatter and an all-gather). Per step:

    * FSDP (a parameter sharded over 'data'): train all-gathers it 2μ
      times (the forward, and the backward with remat's recompute) and
      reduce-scatters its gradient μ times (accumulator dtype), plus an
      all-reduce of the scattered gradient over 'pod' where there is one;
      prefill and decode all-gather it once.
    * DP: a parameter not sharded over 'data' all-reduces its gradient
      over the DP axes once a microbatch (train only).
    * TP residuals: a block whose output projection (``wo``, ``w_down``,
      ``w_out``) contracts a dim sharded over 'model' (a MoE's expert dim
      under EP, through its combine) all-reduces its output (local batch
      × seq × d_model) over 'model': 3 times a
      microbatch in train (forward, remat's recompute, the backward's
      input gradient), once in prefill, once in decode (seq 1).
    * Split-K decode (``sp_decode``): each attention layer merges over
      'model' a (local batch × heads × (head_dim + 2)) float32 partial
      (the pmax and two psums, as one all-reduce). Without it, a KV cache
      sharded on its sequence over 'model' is all-gathered per attention
      layer.

    Left out: the MoE dispatch einsum's reduction, vocab-parallel
    embedding and logits, and the prefill's reshard of K/V into the
    sequence-sharded cache."""
    mesh = rules.mesh
    coll: dict = {}
    size = {a: mesh.shape[a] for a in mesh.axis_names}
    dp = rules.dp
    dp_n = int(np.prod([size[a] for a in dp])) if dp else 1
    mu = step.get("microbatches", 1) if kind == "train" else 1
    gathers = 2 * mu if kind == "train" else 1
    b = step["batch"] // mu
    b_loc = b // dp_n if dp and b % dp_n == 0 else b
    seq = 1 if kind == "decode" else step["seq"]
    mp = rules.mp

    pflat = tree_flatten_with_path(shapes["params"])
    sflat = tree_leaves(specs["params"], is_leaf=is_spec)
    attn_layers = 0
    for (path, leaf), spec in zip(pflat, sflat):
        elems = int(np.prod(leaf.shape))
        axes = _axes(spec)
        other = int(np.prod([size[a] for a in axes if a != "data"]))
        whole = elems / other                  # gathered over 'data'
        pbytes = whole * leaf.dtype.itemsize
        if "data" in axes:
            _add(coll, "all-gather", "data",
                 gathers * _payload(pbytes, size["data"]))
            if kind == "train":
                gbytes = whole * step["acc_bytes"]
                _add(coll, "reduce-scatter", "data",
                     mu * _payload(gbytes, size["data"]))
                if "pod" in size:
                    _add(coll, "all-reduce", "pod", mu * _payload(
                        gbytes / size["data"], size["pod"]))
        elif kind == "train" and dp:
            _add(coll, "all-reduce", "+".join(dp),
                 mu * _payload(whole * step["acc_bytes"], dp_n))
        name = path.rsplit(".", 1)[-1]
        stacked = "['segments']" in path
        layers = leaf.shape[0] if stacked else 1
        if name == "wq":
            attn_layers += layers
        if name in ("wo", "w_out", "w_down") and mp is not None \
                and stacked:
            # every dim but the output's (d_model, the last) is contracted:
            # (in, D), or a MoE's (E, F, D) through the combine einsum
            if mp in spec[1:-1]:
                d = leaf.shape[-1]
                x = b_loc * seq * d * step["act_bytes"]
                reps = 3 * mu if kind == "train" else 1
                _add(coll, "all-reduce", mp,
                     reps * layers * _payload(x, size[mp]))
    if kind == "decode" and mp is not None and attn_layers:
        if step.get("sp_decode"):
            x = b_loc * step["n_heads"] * (step["head_dim"] + 2) * 4
            _add(coll, "all-reduce", mp,
                 attn_layers * _payload(x, size[mp]))
        else:
            cflat = [(p, l) for seg in shapes.get("caches", [])
                     for p, l in tree_flatten_with_path(seg)]
            cspecs = [s for seg in specs.get("caches", [])
                      for s in tree_leaves(seg, is_leaf=is_spec)]
            for (path, leaf), spec in zip(cflat, cspecs):
                if (path.endswith(".k") or path.endswith(".v")) \
                        and len(spec) > 2 and spec[2] == mp:
                    per = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                    bdiv = dp_n if spec[1] is not None else 1
                    _add(coll, "all-gather", mp,
                         _payload(per / bdiv, size[mp]))
    return coll


def by_op(coll: dict) -> dict:
    """``{op: bytes}`` summed over axes."""
    return {op: sum(per.values()) for op, per in coll.items()}


def weighted_collective_bytes(coll: dict) -> float:
    """Per-chip bytes on the wire: all-reduce ≈ 2× payload (RS+AG);
    others ≈ 1× output payload."""
    total = 0.0
    for kind, b in coll.items():
        total += (2.0 if kind == "all-reduce" else 1.0) * b
    return total


def link_rate(mesh, axis: str) -> float:
    """Bytes/s a card moves along ``axis`` (names joined by ``+``):
    NVLink when the axis's cards lie in one node of CARDS_PER_NODE
    (devices numbered in mesh order), else InfiniBand."""
    names = axis.split("+")
    idx = tuple(slice(None) if n in names else 0 for n in mesh.axis_names)
    pos = np.arange(mesh.size).reshape(mesh.devices.shape)[idx]
    return NVLINK_BYTES_PER_S if len(set(pos.reshape(-1)
                                         // CARDS_PER_NODE)) == 1 \
        else IB_BYTES_PER_S


def collective_seconds(coll: dict, mesh) -> float:
    """Seconds of :func:`collective_bytes`' payloads, all-reduces doubled,
    each axis at its :func:`link_rate`, one after another."""
    return sum((2.0 if op == "all-reduce" else 1.0) * b / link_rate(mesh, ax)
               for op, per in coll.items() for ax, b in per.items())


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, collective_s=None,
                   peak_flops: float = BF16_FLOPS) -> dict:
    """The three times and the bound. ``collective_s`` (from
    :func:`collective_seconds`) defaults to the bytes at the InfiniBand
    rate."""
    compute_s = flops_per_chip / peak_flops
    memory_s = bytes_per_chip / HBM_BYTES_PER_S
    coll_s = coll_bytes_per_chip / IB_BYTES_PER_S if collective_s is None \
        else collective_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["bottleneck"] = dom
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, n_params: int, n_active: int, shape) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N_active·D (serve)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
