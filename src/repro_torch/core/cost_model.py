"""False-positive-aware cost estimation (paper §4.2, Table 1).

Two scaling principles over the candidate pool required to yield L valid
results: selectivity scaling (L/s) and precision scaling (L/p). During
speculative in-filtering at low selectivity (s·R_d/p_in ≤ R) the false
positives are pure bridge nodes — traversed anyway — so their overhead is
excluded; the traversal is equivalent to a standard search with effective
pool length (L/s)·(R/R_d).

Total cost = α·IO_pages + β·distance_comps, α=10, β=1 by default.

The analytic compute terms assume every admitted candidate costs one
distance comparison per out-edge (R, or R + γ·R_d with approximate
checks). The fused hop pipeline measures the real counters per query
(``SearchResult.dist_comps`` / ``approx_checks`` / ``hops``), and
``benchmarks/bench_search.py`` persists their per-mode means in
BENCH_search.json — a :class:`Calibration` built from that payload
replaces the hardcoded per-hop constants, so the router trades I/O
against *measured* compute (engine: ``FilteredANNEngine.calibrate``).
"""
from __future__ import annotations

import dataclasses
import json


GAMMA = 0.05   # relative cost of is_member_approx vs one distance comparison


def joint_and_selectivity(margins) -> float:
    """Joint selectivity of a conjunction from per-predicate marginals.

    Independence product clamped to [0, 1] — the ceiling guards inflated
    marginal estimates; the selectivity-scaled pool formulas (L/s) apply
    their own 1e-9 floor downstream. Used by AndSelector and the filter
    compiler for multi-field range conjunctions.
    """
    s = 1.0
    for m in margins:
        s *= float(m)
    return float(min(1.0, max(s, 0.0)))


@dataclasses.dataclass(frozen=True)
class CostInputs:
    n: int            # dataset size
    l: int            # target pool length L
    s: float          # estimated query selectivity
    p_pre: float      # precision of the pre-filter superset
    p_in: float       # precision of is_member_approx
    x_pre: int        # pages: attribute-index scan for pre-filtering
    x_in: int         # pages: initial rare-posting fetch for in-filtering
    r: int            # standard out-degree
    r_d: int          # densified out-degree (direct + 2-hop)
    s_r: int          # pages per standard record
    s_d: int          # pages per densified record
    gamma: float = GAMMA


@dataclasses.dataclass(frozen=True)
class MechanismCost:
    io_pages: float
    compute: float

    def total(self, alpha: float, beta: float) -> float:
        return alpha * self.io_pages + beta * self.compute


@dataclasses.dataclass(frozen=True)
class ModeCal:
    """Measured per-hop compute for one search mode."""
    dist_per_hop: float       # mean dist_comps / mean hops
    approx_per_hop: float     # mean approx_checks / mean hops


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-hop compute constants measured by the fused search pipeline.

    Built from a BENCH_search.json payload (``from_bench``): the bench
    records mean ``dist_comps``/``approx_checks``/``hops`` per mode, and
    their per-hop ratios replace the analytic R / γ·R_d constants in the
    compute terms below. The analytic *hop-count* scaling (1/s, 1/p —
    Table 1) is untouched: calibration refines how much compute one hop
    costs, not how many hops a filter needs. I/O terms stay analytic too
    (page counters are exact by construction)."""
    spec_in: ModeCal
    post: ModeCal

    @classmethod
    def from_bench(cls, payload: dict) -> "Calibration":
        def mode(name: str) -> ModeCal:
            m = payload["modes"][name]
            hops = max(float(m["mean_hops"]), 1e-9)
            return ModeCal(
                dist_per_hop=float(m["mean_dist_comps"]) / hops,
                approx_per_hop=float(m.get("mean_approx_checks", 0.0))
                / hops)
        return cls(spec_in=mode("spec_in"), post=mode("post"))


def load_calibration(path: str = "BENCH_search.json") -> Calibration | None:
    """Calibration from a committed bench payload; None when the file is
    missing or predates the approx-checks counter era."""
    try:
        with open(path) as fh:
            payload = json.load(fh)
        return Calibration.from_bench(payload)
    except (OSError, KeyError, ValueError):
        return None


def pre_filtering_cost(c: CostInputs,
                       calib: Calibration | None = None) -> MechanismCost:
    p = max(c.p_pre, 1e-9)
    io = c.x_pre + (c.l / p) * c.s_r
    compute = c.s * c.n / p
    return MechanismCost(io, compute)


def in_filtering_cost(c: CostInputs,
                      calib: Calibration | None = None) -> MechanismCost:
    s = max(c.s, 1e-9)
    p = max(c.p_in, 1e-9)
    if s * c.r_d / p <= c.r:     # low selectivity: false positives = bridges
        hops = (c.l / s) * (c.r / max(c.r_d, 1))
        io = c.x_in + hops * c.s_d
        compute = (hops + c.gamma * (c.l / s)) * c.r
    else:                        # high selectivity: precision scaling
        hops = c.l / p
        io = c.x_in + hops * c.s_d
        compute = hops * (c.r + c.gamma * c.r_d)
    if calib is not None:
        m = calib.spec_in
        compute = hops * (m.dist_per_hop + c.gamma * m.approx_per_hop)
    return MechanismCost(io, compute)


def post_filtering_cost(c: CostInputs,
                        calib: Calibration | None = None) -> MechanismCost:
    s = max(c.s, 1e-9)
    hops = c.l / s
    io = hops * c.s_r
    compute = hops * c.r if calib is None else hops * calib.post.dist_per_hop
    return MechanismCost(io, compute)


def approx_scan_cost(c: CostInputs, rerank: int) -> MechanismCost:
    """The serving tier's last-rung degrade path: one gated ADC pass over
    the full in-memory code tier (every id is a candidate, approximate
    membership only penalizes the ranking), then exact fetch + verify of
    the top ``rerank`` ids. No graph traversal, no per-hop round-trips.

    I/O is only the re-rank fetch. The scan's per-id ADC is priced at γ —
    the same unit the in-path charges for its per-id table-lookup
    membership checks — because one fused full-corpus pass amortizes far
    better than the hop loop's small sequential gathers that the per-hop
    distance-comp unit was measured on."""
    io = rerank * c.s_r
    compute = c.gamma * c.n + rerank
    return MechanismCost(io, compute)


# ---------------------------------------------------------------------------
# Load-degrade ladder (serve tier) — the load-fault analogue of the read
# fault ladder: each rung trades recall headroom or read-ahead
# footprint for a strictly lower modeled service cost, and every rung
# preserves the no-false-negative contract (scaled-L rungs still verify
# exactly; the scan rung covers every id, its approximate gate only
# over-admits).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradeRung:
    """One step of the overload ladder, as SearchConfig deltas."""
    name: str
    l_scale: float = 1.0          # scales the base pool length L
    max_hops_scale: float = 1.0   # scales the hop budget
    hop_chunk: int | None = None  # override (None keeps the config's)
    prefetch_depth: int | None = None
    approx: bool = False          # serve via the gated full-scan path


DEGRADE_LADDER: tuple = (
    DegradeRung("full"),
    # results-invariant first step: shed the speculative read-ahead
    # footprint and tighten the compaction cadence before touching recall
    DegradeRung("lean", prefetch_depth=1, hop_chunk=16),
    DegradeRung("reduced", l_scale=0.75, max_hops_scale=0.5,
                prefetch_depth=1, hop_chunk=16),
    DegradeRung("minimal", l_scale=0.5, max_hops_scale=0.25,
                prefetch_depth=1, hop_chunk=16),
    DegradeRung("scan", l_scale=0.5, approx=True),
)


def rung_inputs(c: CostInputs, rung: DegradeRung) -> CostInputs:
    return dataclasses.replace(
        c, l=max(1, int(round(c.l * rung.l_scale))))


def rung_cost(c: CostInputs, rung: DegradeRung, alpha: float = 10.0,
              beta: float = 1.0, max_pool: int = 1024,
              base_prefetch: int = 2, rerank: int = 64,
              calib: "Calibration | None" = None) -> float:
    """Raw modeled service cost of one query executed at ``rung``.

    This is the number the admission controller scales into µs. The
    *effective* ladder (``ladder_costs``, running minimum) is what must
    be — and is, by construction — monotone non-increasing: the
    scheduler serves at the cheapest rung its pressure level permits,
    never at a rung the model prices above a lighter one. Read-ahead is priced
    as (depth − 1) speculative slab fetches per query — the pages a
    settling query has in flight that overload turns into waste."""
    ci = rung_inputs(c, rung)
    if rung.approx:
        return approx_scan_cost(ci, rerank).total(alpha, beta)
    route = route_query(ci, alpha, beta, max_pool, calib=calib)
    depth = base_prefetch if rung.prefetch_depth is None \
        else rung.prefetch_depth
    overage = max(0, depth - 1) * c.s_d
    return route.costs[route.mechanism].total(alpha, beta) + alpha * overage


def ladder_costs(c: CostInputs, alpha: float = 10.0, beta: float = 1.0,
                 max_pool: int = 1024, base_prefetch: int = 2,
                 rerank: int = 64, calib: "Calibration | None" = None,
                 effective: bool = True) -> list:
    """[(rung, cost)] over DEGRADE_LADDER, in ladder order.

    With ``effective`` (the default) each entry is the *effective* cost
    at that degradation level — the running minimum over rungs 0..i.
    Pressure level i permits every rung up to i and the scheduler serves
    at the cheapest permitted rung (``serve/server.py``), so the
    effective ladder is monotone non-increasing by construction even
    where a raw rung cost inverts (e.g. the full-corpus scan rung is the
    cheapest escape hatch only when graph traversal is the expensive
    side — low selectivity, deep hop budgets — and the scheduler only
    takes it then). ``effective=False`` returns the raw per-rung costs.
    """
    raw = [rung_cost(c, r, alpha, beta, max_pool, base_prefetch,
                     rerank, calib) for r in DEGRADE_LADDER]
    if effective:
        run = []
        best = float("inf")
        for v in raw:
            best = min(best, v)
            run.append(best)
        raw = run
    return list(zip(DEGRADE_LADDER, raw))


@dataclasses.dataclass(frozen=True)
class Route:
    mechanism: str           # 'pre' | 'in' | 'post'
    costs: dict
    effective_l: int         # pool length the executor should use


def effective_l(mech: str, c: CostInputs, max_pool: int,
                strict: bool = False) -> int:
    """Pool length the executor should use for a mechanism (paper §4.2).

    The same selectivity/precision scaling that prices a mechanism also
    sizes its pool, so both the speculative router and the forced-policy
    baselines share this one implementation.

    ``strict`` applies to ``mech == "in"`` only: strict in-filtering
    (Filtered-DiskANN-like) admits only exactly-verified nodes to the pool
    and traverses without bridge nodes or the densified 2-hop edges, so the
    speculative bridge-regime scaling (L/s)·(R/R_d) badly *under*-sizes its
    pool at low selectivity. The valid sub-graph it walks is sparse and
    fragmented; keeping a 1/s-deep frontier of valid nodes is what lets the
    traversal escape local minima, exactly like post-filtering's pool.
    """
    s = max(c.s, 1e-9)
    if mech == "post":
        eff = int(c.l / s) + c.l
    elif mech == "in":
        p = max(c.p_in, 1e-9)
        if strict:                   # strict baseline: selectivity scaling
            eff = int(c.l / s) + c.l
        elif s * c.r_d / p <= c.r:   # low selectivity: bridge-node regime
            eff = int((c.l / s) * (c.r / max(c.r_d, 1))) + c.l
        else:                        # high selectivity: precision scaling
            eff = int(c.l / p) + c.l
    elif mech == "pre":
        eff = int(c.l / max(c.p_pre, 1e-9)) + c.l
    else:
        raise ValueError(mech)
    return max(c.l, min(max_pool, eff))


def route_query(c: CostInputs, alpha: float = 10.0, beta: float = 1.0,
                max_pool: int = 4096,
                calib: Calibration | None = None) -> Route:
    """Pick the cheapest mechanism and size its search parameters."""
    costs = {
        "pre": pre_filtering_cost(c, calib),
        "in": in_filtering_cost(c, calib),
        "post": post_filtering_cost(c, calib),
    }
    totals = {k: v.total(alpha, beta) for k, v in costs.items()}
    mech = min(totals, key=totals.get)
    return Route(mechanism=mech, costs=costs,
                 effective_l=effective_l(mech, c, max_pool))
