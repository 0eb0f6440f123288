"""Model configuration and shared building blocks (norms, rotary, init).

Counterpart of ``repro.models.common``, with its activation-sharding
context (:func:`set_activation_sharding`, :func:`constrain_dims`,
:func:`shard_batch_dim`). The port is single-controller: a constraint
places nothing, so these resolve and check the spec JAX would constrain
to and return their input, as ``jax.lax.with_sharding_constraint`` returns
its input's values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    group_size: int = 1024          # dispatch group (memory bound)
    dispatch: str = "dense"         # 'dense' (GShard einsum) | 'sort' (ragged)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer pattern: segments of (repeat, (block kinds...)); each segment
    # repeats its period of block kinds `repeat` times
    # kinds: 'attn_mlp' | 'attn_moe' | 'mamba' | 'mamba_mlp' | 'mamba_moe'
    # | 'arctic' (models/blocks.py)
    segments: tuple = ()
    mlp_type: str = "swiglu"        # 'swiglu' | 'gelu'
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                 # sliding-window size (0 = full attention)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: str = "none"          # 'none' | 'audio' | 'vision'
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True              # read by training only
    # attention execution knobs
    attn_chunk_q: int = 1024        # blockwise (flash-style) prefill chunks
    attn_chunk_kv: int = 1024
    attn_chunk_threshold: int = 2048   # use blockwise above this seq len
    vision_prefix: int = 0          # vlm: number of patch-embedding positions
    sp_decode: bool = False         # split-K decode over the mesh's model axis
    decode_unroll: bool = False     # accepted; changes nothing in the port

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (SSM/hybrid/SWA ring).

        Hybrids (jamba) count as sub-quadratic: their few full-attention
        layers keep an O(T) KV cache but no O(T²) compute at decode."""
        kinds = [k for _, period in self.segments for k in period]
        has_attn = any(k.startswith("attn") or k == "arctic" for k in kinds)
        all_attn = all(k.startswith("attn") or k == "arctic" for k in kinds)
        if not has_attn:
            return True                      # pure SSM
        if self.window > 0:
            return True                      # SWA ring cache
        return not all_attn                  # hybrid: attn minority

    @property
    def layer_kinds(self) -> list:
        out = []
        for repeat, period in self.segments:
            out.extend(list(period) * repeat)
        return out


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    """A parameter that takes no gradient (the serving path computes none)."""
    return None if t is None else nn.Parameter(t, requires_grad=False)


class ParamGroup(nn.Module):
    """Named leaves of one layer, as the JAX package's ``NamedTuple`` of
    arrays: each name in ``FIELDS`` is a parameter or ``None``."""
    FIELDS: tuple = ()

    def __init__(self, **leaves):
        super().__init__()
        for name in self.FIELDS:
            self.register_parameter(name, frozen(leaves[name]))


def dense_init(generator: Optional[torch.Generator], shape, dtype,
               scale: float = 0.02, device=None) -> torch.Tensor:
    """N(0, scale²) drawn in float32 from ``generator`` on its device, cast
    to ``dtype``. With no generator, an uninitialised tensor on ``device``
    (``meta`` gives shapes only)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def uniform_init(generator: Optional[torch.Generator], shape, lo: float,
                 hi: float, device=None) -> torch.Tensor:
    """U[lo, hi) in float32 from ``generator`` (uninitialised without one,
    as :func:`dense_init`)."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    out = torch.rand(shape, generator=generator, device=generator.device,
                     dtype=torch.float32)
    return out.mul_(hi - lo).add_(lo)


# ---------------------------------------------------------------------------
# shared ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm with the mean square accumulated in float32 from the inputs
    in their own dtype (a float32 product of the bfloat16 values, not a
    bfloat16 product widened after)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * scale.to(dt)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Apply RoPE. x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs         # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activation-sharding context (set by the launcher before a step runs)
# ---------------------------------------------------------------------------

_ACT_CTX = {"mesh": None, "dp": None, "sp": None}


def set_activation_sharding(mesh, dp_axes, seq_axis=None):
    """Install the mesh (``launch.mesh.Mesh``) that activation constraints
    and the split-K decode (``attention._sp_decode_core``) read.
    ``seq_axis`` names the axis that shards the residual stream's
    sequence dim between blocks (Megatron-style sequence parallelism)."""
    _ACT_CTX["mesh"] = mesh
    _ACT_CTX["dp"] = dp_axes
    _ACT_CTX["sp"] = seq_axis


def clear_activation_sharding():
    _ACT_CTX["mesh"] = None
    _ACT_CTX["dp"] = None
    _ACT_CTX["sp"] = None


def _resolve(mesh, axis_kind):
    if axis_kind == "dp":
        return _ACT_CTX["dp"]
    if axis_kind == "mp":
        return "model" if "model" in mesh.axis_names else None
    if axis_kind == "sp":
        return _ACT_CTX["sp"]
    if axis_kind == "all":      # fully-sharded token dims (dp × model)
        dp = _ACT_CTX["dp"] or ()
        mp = ("model",) if "model" in mesh.axis_names else ()
        return tuple(dp) + mp if (dp or mp) else None
    return None


def activation_spec(shape, *axis_kinds) -> Optional[tuple]:
    """The spec :func:`constrain_dims` constrains a tensor of ``shape``
    to, one entry per dim (an axis name, a tuple of names or None), by
    per-dim kind ('dp'|'mp'|'sp'|'all'|None); a dim that does not divide
    over its axes replicates. None without an installed mesh."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None:
        return None
    spec = []
    for dim, kind in enumerate(axis_kinds[:len(shape)]):
        axes = _resolve(mesh, kind)
        if axes is None:
            spec.append(None)
            continue
        size = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            size *= mesh.shape[a]
        spec.append(axes if shape[dim] % size == 0 else None)
    return tuple(spec + [None] * (len(shape) - len(spec)))


def constrain_dims(x, *axis_kinds):
    """``with_sharding_constraint`` by per-dim kind: the spec is resolved
    (:func:`activation_spec`) and ``x`` returned, since one controller
    holds the whole tensor; the identity without context."""
    activation_spec(x.shape, *axis_kinds)
    return x


def shard_batch_dim(x, dim: int = 0):
    """Constrain dim 0 to DP (and, when enabled, the next dim to SP)."""
    kinds = [None] * x.ndim
    kinds[dim] = "dp"
    if dim + 1 < x.ndim and _ACT_CTX["sp"] is not None and x.ndim >= 3:
        kinds[dim + 1] = "sp"
    return constrain_dims(x, *kinds)
