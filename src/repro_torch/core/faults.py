"""Deterministic fault injection for the simulated SSD read path.

Counterpart of ``repro.core.faults``: the same plans draw the same faults,
bit for bit. Real SSD reads fail, stall and return garbage; the engine must
survive all three without breaking the no-false-negative contract
(verification is post hoc, so a lost record slab can always be
approximated, never silently dropped). This module is the single source of
fault decisions:

* **record reads** (the hop loop's frontier slab fetch): page-read
  failures, corrupted slabs and latency spikes, drawn per
  ``(record id, hop, attempt)`` by a stateless hash, so a plan reproduces
  the same faults in any execution order — the pipelined search compacts and
  reorders query rows freely and stays bit-identical to the single-shot
  search;
* **checkpoint writes** (:class:`FaultInjector`): flaky leaf writes, drawn
  per ``(step, leaf, attempt)`` on the host by the same tensor hash.

The search-side ladder on a failed or corrupted slab read is
**retry → hedge → degrade**: retry up to ``max_retries`` times, then one
hedged read (``hedge=True``); a row whose every attempt failed is answered
from the in-memory tier (its ADC distance and ``is_member_approx``, a
no-false-negative superset) and its neighbours are not expanded; the query
completes with ``degraded > 0``.

The hash is uint32 arithmetic. PyTorch has no full uint32 type, so the
tensor draws hold uint32 values in int64 and mask every product with
``& 0xFFFFFFFF``: a product of two uint32 values can pass int64's range,
but it wraps modulo 2**64, which keeps its low 32 bits. The uniform draw
rounds the uint32 to float32, scales by 2**-32 and compares against the
rate as a float32, as the JAX package does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# decision streams: decorrelate the draw families sharing one seed
_STREAM_FAIL = 0x1
_STREAM_CORRUPT = 0x2
_STREAM_SPIKE = 0x3
_STREAM_CKPT = 0x4

_GOLDEN = 0x9E3779B9          # 2^32 / phi — the usual Weyl increments
_MIX_A = 0x7FEB352D           # splitmix32 finalizer constants
_MIX_B = 0x846CA68B
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, reproducible fault schedule (hashable: it rides
    ``SearchParams``/``SearchConfig``, which group queries by config).

    Rates are per-attempt probabilities; a read permanently fails (and
    degrades) only when the first read, every retry and the hedge all draw
    bad — p_bad^(1+max_retries+hedge)."""
    seed: int = 0
    read_fail_rate: float = 0.0    # P[page read fails] per attempt
    corrupt_rate: float = 0.0      # P[slab checksum mismatch] per attempt
    spike_rate: float = 0.0        # P[read latency spike] (accounting only)
    spike_factor: float = 8.0      # spiked read takes this × t_page_us
    ckpt_fail_rate: float = 0.0    # P[checkpoint leaf write fails]
    max_retries: int = 2           # extra read attempts before hedging
    hedge: bool = True             # one final hedged read after retries
    backoff_us: float = 50.0       # first-retry backoff (doubles per retry)
    backoff_cap_us: float = 800.0  # exponential backoff cap

    def __post_init__(self):
        for f in ("read_fail_rate", "corrupt_rate", "spike_rate",
                  "ckpt_fail_rate"):
            v = getattr(self, f)
            assert 0.0 <= v <= 1.0, f"{f}={v} outside [0, 1]"
        assert self.max_retries >= 0

    @property
    def reads_faulty(self) -> bool:
        """Whether the read path runs any fault logic at all."""
        return (self.read_fail_rate > 0.0 or self.corrupt_rate > 0.0
                or self.spike_rate > 0.0)

    @property
    def attempts(self) -> int:
        """Total read attempts in the ladder: 1 + retries (+ hedge)."""
        return 1 + self.max_retries + (1 if self.hedge else 0)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls(**d)


def parse_plan(spec: str) -> FaultPlan:
    """Parse a CLI plan spec: comma-separated ``key=value`` pairs.

    ``rate=`` is shorthand for ``read_fail_rate=``; booleans accept
    0/1/true/false. Example: ``rate=0.1,seed=7,max_retries=2,hedge=1``.
    """
    kw: dict = {}
    fields = {f.name: f for f in dataclasses.fields(FaultPlan)}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key == "rate":
            key = "read_fail_rate"
        field = fields.get(key)
        if field is None:
            raise ValueError(f"unknown FaultPlan field {key!r}")
        if field.type == "bool" or isinstance(field.default, bool):
            kw[key] = val.strip().lower() in ("1", "true", "yes")
        elif isinstance(field.default, int):
            kw[key] = int(val)
        else:
            kw[key] = float(val)
    return FaultPlan(**kw)


def _key(seed: int, stream: int, attempt: int) -> int:
    return (seed * _GOLDEN + stream * _MIX_A + attempt * _MIX_B) & _U32


# ---------------------------------------------------------------------------
# Stateless decision hash on tensors (uint32 values held in int64)
# ---------------------------------------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on uint32 values held in an int64 tensor."""
    x = ((x ^ (x >> 16)) * _MIX_A) & _U32
    x = ((x ^ (x >> 15)) * _MIX_B) & _U32
    return x ^ (x >> 16)


def _uniform(ids: torch.Tensor, hops: torch.Tensor, seed: int, stream: int,
             attempt: int) -> torch.Tensor:
    """Deterministic uniform [0, 1) float32 per (id, hop, stream, attempt);
    ``ids`` and ``hops`` broadcast against each other. It depends only on
    row-local values (record id and that query's own hop counter), never on
    batch position."""
    u = _mix32((ids.long() & _U32) ^ _key(seed, stream, attempt))
    u = _mix32(u ^ (((hops.long() & _U32) * _GOLDEN) & _U32))
    return u.to(torch.float32) * (2.0 ** -32)


def _rate(rate: float, like: torch.Tensor) -> torch.Tensor:
    """The rate as a float32 tensor: the threshold is compared in float32."""
    return torch.tensor(rate, dtype=torch.float32, device=like.device)


def read_attempt_bad(ids: torch.Tensor, hops: torch.Tensor, attempt: int,
                     plan: FaultPlan) -> torch.Tensor:
    """True where read ``attempt`` of these rows fails OR comes back
    corrupted (a detected checksum mismatch re-enters the same ladder)."""
    u = _uniform(ids, hops, plan.seed, _STREAM_FAIL, attempt)
    bad = u < _rate(plan.read_fail_rate, u)
    if plan.corrupt_rate > 0.0:
        u = _uniform(ids, hops, plan.seed, _STREAM_CORRUPT, attempt)
        bad = bad | (u < _rate(plan.corrupt_rate, u))
    return bad


def read_spike(ids: torch.Tensor, hops: torch.Tensor,
               plan: FaultPlan) -> torch.Tensor:
    """True where the (eventually successful) read hits a latency spike.
    Accounting only — spikes feed the modeled latency, never results."""
    u = _uniform(ids, hops, plan.seed, _STREAM_SPIKE, 0)
    return u < _rate(plan.spike_rate, u)


# ---------------------------------------------------------------------------
# NumPy twins (the disk tier's host read path, storage/disk.py)
#
# The disk tier draws its faults on the host, where it reads the pages, but
# the degraded-row substitution happens in the hop step on the tensors: both
# must see the same draws, or a host-degraded row's zeros would be consumed.
# The twins compute the hash in uint32 (wraparound on every product), round
# the uint32 to float32, scale by the float32 2**-32 and compare against the
# float32 rate, as the tensor draws and ``repro``'s twins do.
# ---------------------------------------------------------------------------

def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint32(16))) * np.uint32(_MIX_A)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(_MIX_B)
    return x ^ (x >> np.uint32(16))


def _uniform_np(ids, hops, seed: int, stream: int,
                attempt: int) -> np.ndarray:
    key = np.uint32(_key(seed, stream, attempt))
    with np.errstate(over="ignore"):    # uint32 wraparound is the point
        u = _mix32_np(np.asarray(ids).astype(np.uint32) ^ key)
        u = _mix32_np(u ^ (np.asarray(hops).astype(np.uint32)
                           * np.uint32(_GOLDEN)))
    return u.astype(np.float32) * np.float32(2.0 ** -32)


def read_fail_np(ids, hops, attempt: int, plan: FaultPlan) -> np.ndarray:
    return (_uniform_np(ids, hops, plan.seed, _STREAM_FAIL, attempt)
            < np.float32(plan.read_fail_rate))


def read_corrupt_np(ids, hops, attempt: int, plan: FaultPlan) -> np.ndarray:
    if plan.corrupt_rate <= 0.0:
        return np.zeros(np.broadcast(np.asarray(ids), np.asarray(hops)).shape,
                        bool)
    return (_uniform_np(ids, hops, plan.seed, _STREAM_CORRUPT, attempt)
            < np.float32(plan.corrupt_rate))


def read_attempt_bad_np(ids, hops, attempt: int,
                        plan: FaultPlan) -> np.ndarray:
    """NumPy twin of :func:`read_attempt_bad` (fail OR corrupt)."""
    return read_fail_np(ids, hops, attempt, plan) | read_corrupt_np(
        ids, hops, attempt, plan)


# ---------------------------------------------------------------------------
# Host-side injector (checkpoint writes)
# ---------------------------------------------------------------------------

class FaultInjector:
    """Host-side fault oracle for checkpoint leaf writes: the same
    stateless hash, so a plan fails the same (step, leaf) pairs on every
    run. ``n_write_faults`` counts what fired."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.n_write_faults = 0

    def ckpt_write_fails(self, step: int, leaf_index: int,
                         attempt: int = 0) -> bool:
        p = self.plan.ckpt_fail_rate
        if p <= 0.0:
            return False
        u = _mix32(torch.tensor(leaf_index & _U32)
                   ^ _key(self.plan.seed, _STREAM_CKPT, attempt))
        u = _mix32(u ^ (((step & _U32) * _GOLDEN) & _U32))
        fails = int(u) * 2.0 ** -32 < p
        if fails:
            self.n_write_faults += 1
        return bool(fails)
