"""Sharding rules: map parameter/optimizer/cache/data trees to partition
specs on a mesh. Counterpart of ``repro.launch.shardings``, whose rules
are copied here path for path.

Conventions:
  * DP: batch over ('pod','data');
  * TP: attention heads / d_ff / SSM inner dim over 'model';
  * EP: expert dim over 'model' when n_experts divides the axis
    (arctic 128e, jamba 16e), d_ff TP fallback otherwise (mixtral 8e);
  * FSDP: parameter dim-0 (d_model) + optimizer moments over 'data' when
    enabled;
  * vocab over 'model' for embed/lm_head;
  * decode KV caches shard their sequence dim over 'model' (split-K
    attention); mamba states shard heads over 'model'.

Every sharded dim is divisibility-checked; non-divisible dims fall back to
replication, so any (arch × mesh) combination has specs.

The rules read ``keystr`` paths (``utils.tree.tree_flatten_with_path``) of
trees in ``repro``'s layout: ``models.convert.to_repro_tree`` (parameters,
stacked under ``['segments']``), ``train_loop.train_state_tree``'s
``OptState`` (``.m``/``.v``, ``Q8`` as ``.q``/``.scale``) and
``models.convert.caches_to_repro_tree`` (decode caches). Leaves need only
``.shape`` and ``.dtype``: ``meta`` tensors do.

The port is single-controller (``core.distributed``): a
:class:`NamedSharding` places a leaf on its mesh's device, which is one
device on a local mesh (every shard a view of that one tensor).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.utils.tree import (tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_unflatten)


class P(tuple):
    """A partition spec: one entry per dim, ``None`` (replicated), an axis
    name, or a tuple of axis names. As ``jax.sharding.PartitionSpec``, a
    tuple of one name is that name and an empty one is ``None``."""

    def __new__(cls, *axes):
        def canon(a):
            if isinstance(a, tuple) and len(a) <= 1:
                return a[0] if a else None
            return a
        return super().__new__(cls, tuple(canon(a) for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Mesh
    fsdp: bool = False

    @property
    def dp(self):
        return dp_axes(self.mesh)

    @property
    def mp(self):
        return "model" if "model" in self.mesh.axis_names else None

    def ax(self, dim: int, axis):
        """axis if dim divides the axis size, else None (replicate)."""
        if axis is None:
            return None
        return axis if dim % axis_size(self.mesh, axis) == 0 else None

    def fsdp_ax(self, dim: int):
        if not self.fsdp:
            return None
        return self.ax(dim, "data" if "data" in self.mesh.axis_names else None)


def axis_size(mesh: Mesh, axis) -> int:
    """Positions along ``axis`` (a name or a tuple of names)."""
    s = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        s *= mesh.shape[a]
    return s


def _param_spec(rules: Rules, keystr: str, shape: tuple) -> P:
    r = rules
    mp = r.mp
    stacked = "['segments']" in keystr        # leading repeat dim
    lead = (None,) if stacked else ()
    s = shape[1:] if stacked else shape

    def out(*axes):
        return P(*(lead + tuple(axes)))

    name = keystr.split(".")[-1] if "." in keystr else keystr
    if name.endswith("']"):                   # dict key like ['embed']
        name = keystr.rsplit("['", 1)[-1].rstrip("']")

    if name == "embed":
        return P(r.ax(s[0], mp), r.fsdp_ax(s[1]))
    if name == "lm_head":
        return P(r.fsdp_ax(s[0]), r.ax(s[1], mp))
    if name == "final_norm":
        return P(None)
    if name in ("wq", "wk", "wv"):
        return out(r.fsdp_ax(s[0]), r.ax(s[1], mp))
    if name == "wo":
        return out(r.ax(s[0], mp), r.fsdp_ax(s[1]))
    if name in ("bq", "bk", "bv"):
        return out(r.ax(s[0], mp))
    if name in ("w_gate", "w_up"):
        if len(s) == 3:                        # (E, D, F) expert weights
            if r.ax(s[0], mp):
                return out(mp, r.fsdp_ax(s[1]), None)
            return out(None, r.fsdp_ax(s[1]), r.ax(s[2], mp))
        return out(r.fsdp_ax(s[0]), r.ax(s[1], mp))
    if name == "w_down":
        if len(s) == 3:                        # (E, F, D)
            if r.ax(s[0], mp):
                return out(mp, None, r.fsdp_ax(s[2]))
            return out(None, r.ax(s[1], mp), r.fsdp_ax(s[2]))
        return out(r.ax(s[0], mp), r.fsdp_ax(s[1]))
    if name == "w_router":
        return out(None, None)
    if name in ("w_z", "w_x"):
        return out(r.fsdp_ax(s[0]), r.ax(s[1], mp))
    if name in ("w_b", "w_c"):
        return out(r.fsdp_ax(s[0]), None)
    if name == "w_dt":
        return out(r.fsdp_ax(s[0]), r.ax(s[1], mp))
    if name == "conv_x":
        return out(None, r.ax(s[1], mp))
    if name in ("conv_x_b", "norm_scale"):
        return out(r.ax(s[0], mp))
    if name in ("conv_bc", "conv_bc_b"):
        return out(*([None] * len(s)))
    if name in ("a_log", "dt_bias", "d_skip"):
        return out(r.ax(s[0], mp))
    if name == "w_out":
        return out(r.ax(s[0], mp), r.fsdp_ax(s[1]))
    if name in ("ln1", "ln2"):
        return out(None)
    # default: replicate
    return P(*([None] * len(shape)))


def _specs(tree, spec_for) -> object:
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [spec_for(p, leaf) for p, leaf in flat])


def param_specs(rules: Rules, params_shapes) -> object:
    """Spec tree matching a params shape tree in ``repro``'s layout."""
    return _specs(params_shapes, lambda ks, leaf: _param_spec(
        rules, ks, tuple(leaf.shape)))


def opt_specs(rules: Rules, opt_shapes, params_shapes) -> object:
    """Optimizer-state specs: float moments follow their parameter's spec;
    Q8 ``q``/``scale`` inherit it too (the scale's block-count last dim
    replicates unless divisible)."""
    by_key = {ks: tuple(leaf.shape)
              for ks, leaf in tree_flatten_with_path(params_shapes)}

    def spec_for(ks, leaf):
        if ks.startswith(".step") or ks == "[0]":
            return P()
        # strip the leading ".m" / ".v" OptState field
        base = ks
        for prefix in (".m", ".v"):
            if base.startswith(prefix):
                base = base[len(prefix):]
                break
        q8_field = None
        for suffix in (".q", ".scale"):
            if base.endswith(suffix):
                q8_field = suffix
                base = base[:-len(suffix)]
                break
        pshape = by_key.get(base)
        if pshape is None:
            return P(*([None] * len(leaf.shape)))
        spec = _param_spec(rules, base, pshape)
        if q8_field is None:
            return spec
        axes = list(spec) + [None] * (len(leaf.shape) - len(spec))
        axes = axes[:len(leaf.shape)]
        last = axes[-1]
        if last is not None and \
                leaf.shape[-1] % axis_size(rules.mesh, last):
            axes[-1] = None
        return P(*axes)

    return _specs(opt_shapes, spec_for)


def data_specs(rules: Rules, specs: dict, global_batch: int) -> dict:
    """Batch inputs: dim 0 over DP axes when divisible."""
    b_ax = rules.ax(global_batch, rules.dp)
    return {k: P(*((b_ax,) + (None,) * (len(v.shape) - 1)))
            for k, v in specs.items()}


def cache_specs(rules: Rules, cache_shapes, batch: int) -> object:
    """Decode caches (one segment of ``convert.caches_to_repro_tree``):
    KV seq over 'model', batch over DP, SSM heads over 'model'. Leaves
    carry a leading stacked-repeat dim."""
    b_ax = rules.ax(batch, rules.dp)
    mp = rules.mp

    def spec_for(ks, leaf):
        s = tuple(leaf.shape)
        if ".k" in ks or ".v" in ks:          # (R, B, T, Hkv, Dh)
            return P(None, b_ax, rules.ax(s[2], mp), None, None)
        if ".pos" in ks:
            return P(*([None] * len(s)))
        if ks.endswith(".s"):                  # (R, B, G, HG, P, N)
            return P(None, b_ax, None, rules.ax(s[3], mp), None, None)
        if ".conv_x" in ks:                    # (R, B, W-1, di)
            return P(None, b_ax, None, rules.ax(s[3], mp))
        if ".conv_bc" in ks:
            return P(None, b_ax, None, None)
        return P(*([None] * len(s)))

    return _specs(cache_shapes, spec_for)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: its spec on a mesh."""
    mesh: Mesh
    spec: P

    def check(self, shape) -> None:
        """Each sharded dim divides by its axes' size, as JAX requires of a
        sharding it is given."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than shape "
                             f"{tuple(shape)}")
        for dim, axis in enumerate(self.spec):
            if axis is not None and \
                    shape[dim] % axis_size(self.mesh, axis):
                raise ValueError(
                    f"shape {tuple(shape)}: dim {dim} ({shape[dim]}) does "
                    f"not divide over {axis} ({axis_size(self.mesh, axis)})")

    @property
    def device(self) -> torch.device:
        """The one device the mesh holds. A single controller keeps a leaf
        whole on one device: a mesh over distinct devices raises."""
        devs = self.mesh.distinct_devices
        if len(devs) > 1:
            raise NotImplementedError(
                f"the mesh spans {len(devs)} distinct devices; the port "
                "places a leaf on one device (a local mesh), and a layout "
                "across cards needs a multi-card machine")
        return devs[0]

    def place(self, x) -> torch.Tensor:
        """``x`` (a tensor, or a numpy array, bfloat16 from ``ml_dtypes``
        too) checked against the spec and moved to :attr:`device`."""
        self.check(tuple(x.shape))
        if isinstance(x, np.ndarray):
            if x.dtype.name == "bfloat16":
                x = torch.from_numpy(np.array(x).view(np.int16)).view(
                    torch.bfloat16)
            else:
                x = torch.from_numpy(np.array(x))
        return x.to(self.device)


def named(mesh: Mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=is_spec)


def check_specs(shapes, specs, mesh: Mesh) -> None:
    """Every leaf of ``shapes`` divides as its spec says (raises
    otherwise): what ``with_sharding_constraint`` checks."""
    flat_s = tree_leaves(shapes)
    flat_p = tree_leaves(specs, is_leaf=is_spec)
    assert len(flat_s) == len(flat_p), (len(flat_s), len(flat_p))
    for sh, sp in zip(flat_s, flat_p):
        NamedSharding(mesh, sp).check(tuple(sh.shape))


def _itemsize(dt) -> int:
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    return int(np.dtype(dt).itemsize)


def sharded_bytes(shapes, specs, mesh: Mesh) -> int:
    """Static per-device bytes of a sharded tree (memory sanity)."""
    flat_s = tree_leaves(shapes)
    flat_p = tree_leaves(specs, is_leaf=is_spec)
    total = 0
    for sh, sp in zip(flat_s, flat_p):
        n = int(np.prod(sh.shape)) if len(sh.shape) else 1
        denom = 1
        for axis in sp:
            if axis is not None:
                denom *= axis_size(mesh, axis)
        total += n * _itemsize(sh.dtype) // denom
    return total
