"""Declarative filter-expression DSL compiled onto the engine's Selector
algebra (paper §4.1/§4.3 exposed redisvl-style).

Expressions are built from two field handles::

    Tag("topic") == 5                       # categorical equality
    Tag("topic").isin([3, 5, 9])            # membership (OR of equalities)
    Num("price").between(10.0, 90.0)        # numeric range [lo, hi)
    Num("year") >= 2020                     # open-ended ranges

and composed with ``&`` / ``|`` into an AND/OR tree; field names resolve
against the index :class:`~repro_torch.api.schema.Schema` (unknown names
raise :class:`~repro_torch.api.schema.UnknownFieldError` at compile time).
``compile_expr`` normalizes the tree and lowers it onto the built-in
selectors (``LabelAndSelector`` / ``LabelOrSelector`` / ``RangeSelector``
and their combinators) whenever the shape fits the approximate QueryFilter
algebra — so a compiled filter is bit-identical to the hand-built
equivalent. Conjunctions may mix one tag group with ranges over up to
``qr`` distinct numeric fields (same-field ranges intersect into one
interval first); these compile natively onto the device verification path.
Shapes the algebra cannot express (nested AND-of-OR trees, more labels
than the QL query slots, more range fields than the qr predicate slots,
unions of disjoint ranges) fall back to an exact host-evaluated
:class:`~repro_torch.core.selectors.MaskSelector`, which forces the
pre-filtering route and thereby preserves the no-false-negative guarantee
end to end.

Counterpart of ``repro.api.filters``, copied onto the port's selectors; the
compiled plans and ``eval_mask`` equal ``repro``'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.api.schema import UnknownFieldError
from repro_torch.core.selectors import (AndSelector, LabelAndSelector,
                                        LabelOrSelector, MaskSelector,
                                        OrSelector, RangeSelector, Selector)


# ---------------------------------------------------------------------------
# Expression tree
# ---------------------------------------------------------------------------

class FilterExpr:
    """Base class for filter expression nodes."""

    def __and__(self, other: "FilterExpr") -> "FilterExpr":
        return And.of(self, other)

    def __or__(self, other: "FilterExpr") -> "FilterExpr":
        return Or.of(self, other)


@dataclasses.dataclass(frozen=True)
class TagIs(FilterExpr):
    """Record has tag ``value`` in categorical field ``field``."""
    field: str
    value: object

    def __repr__(self):
        return f"Tag({self.field!r}) == {self.value!r}"


@dataclasses.dataclass(frozen=True)
class NumRange(FilterExpr):
    """Record's numeric field falls in the half-open interval [lo, hi)."""
    field: str
    lo: float
    hi: float

    def __repr__(self):
        return f"Num({self.field!r}).between({self.lo!r}, {self.hi!r})"


def _flatten(cls, children: Sequence[FilterExpr]) -> tuple:
    out: list = []
    for c in children:
        if not isinstance(c, FilterExpr):
            raise TypeError(f"filter operands must be FilterExpr, got {c!r}")
        if isinstance(c, cls):
            out.extend(c.children)
        else:
            out.append(c)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class And(FilterExpr):
    children: tuple

    @classmethod
    def of(cls, *children: FilterExpr) -> FilterExpr:
        flat = _flatten(cls, children)
        return flat[0] if len(flat) == 1 else cls(flat)

    def __repr__(self):
        return "(" + " & ".join(repr(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class Or(FilterExpr):
    children: tuple

    @classmethod
    def of(cls, *children: FilterExpr) -> FilterExpr:
        flat = _flatten(cls, children)
        return flat[0] if len(flat) == 1 else cls(flat)

    def __repr__(self):
        return "(" + " | ".join(repr(c) for c in self.children) + ")"


class Tag:
    """Handle for a categorical metadata field."""

    def __init__(self, field: str):
        self.field = field

    def __eq__(self, value) -> TagIs:                    # type: ignore[override]
        return TagIs(self.field, value)

    def __hash__(self):
        return hash(("Tag", self.field))

    def isin(self, values: Sequence) -> FilterExpr:
        vals = list(values)
        if not vals:
            raise ValueError(f"Tag({self.field!r}).isin() needs ≥1 value")
        return Or.of(*[TagIs(self.field, v) for v in vals])


def _next_up_f32(x: float) -> float:
    """Smallest float32 strictly greater than x.

    Boundary nudges must happen in float32: the stores hold float32
    values and QueryFilter casts bounds to float32, where a float64
    nextafter collapses back onto x and empties the interval."""
    return float(np.nextafter(np.float32(x), np.float32(np.inf)))


class Num:
    """Handle for a numeric metadata field (one per ``Schema.nums`` entry)."""

    def __init__(self, field: str):
        self.field = field

    def between(self, lo: float, hi: float) -> NumRange:
        """Half-open interval [lo, hi) — the engine's native range shape."""
        return NumRange(self.field, float(lo), float(hi))

    def __lt__(self, x: float) -> NumRange:
        return NumRange(self.field, -math.inf, float(x))

    def __le__(self, x: float) -> NumRange:
        return NumRange(self.field, -math.inf, _next_up_f32(x))

    def __ge__(self, x: float) -> NumRange:
        return NumRange(self.field, float(x), math.inf)

    def __gt__(self, x: float) -> NumRange:
        return NumRange(self.field, _next_up_f32(x), math.inf)

    def __eq__(self, x) -> NumRange:                     # type: ignore[override]
        return NumRange(self.field, float(x), _next_up_f32(x))

    def __hash__(self):
        return hash(("Num", self.field))


# ---------------------------------------------------------------------------
# Compiler: expression tree -> Selector
# ---------------------------------------------------------------------------
# The catalog duck type (implemented by api.Index) provides:
#   label_id(field, value) -> int | None
#   schema, label_store, range_store (MultiRangeStore), n_vectors, ql, qr


def _check_fields(expr: FilterExpr, catalog):
    """Compile-time field resolution: every referenced field must exist in
    the index schema (UnknownFieldError — *not* an empty result or a
    device-dispatch failure). Unknown tag *values* are legitimate (they
    match nothing); unknown *fields* are query bugs."""
    schema = catalog.schema
    for node in _walk(expr):
        if isinstance(node, NumRange):
            schema.num_index(node.field)
        elif isinstance(node, TagIs):
            schema.check_tag(node.field)


def _walk(expr: FilterExpr):
    yield expr
    if isinstance(expr, (And, Or)):
        for c in expr.children:
            yield from _walk(c)


def _merge_ranges_and(ranges: Sequence[NumRange]) -> list:
    """Intersect same-field intervals; one NumRange per distinct field,
    in first-appearance order."""
    by_field: dict = {}
    for r in ranges:
        if r.field in by_field:
            prev = by_field[r.field]
            by_field[r.field] = NumRange(r.field, max(prev.lo, r.lo),
                                         min(prev.hi, r.hi))
        else:
            by_field[r.field] = r
    return list(by_field.values())


def _label_selector(labels: Sequence[int], mode: str, catalog):
    if mode == "or" or len(labels) == 1:
        return LabelOrSelector(catalog.label_store, labels)
    return LabelAndSelector(catalog.label_store, labels)


def _range_selector(catalog, rng: NumRange) -> RangeSelector:
    return RangeSelector(catalog.range_store, rng.lo, rng.hi,
                         field=catalog.schema.num_index(rng.field))


def _try_builtin(expr: FilterExpr, catalog) -> Selector | None:
    """Lower onto the built-in selector algebra; None if inexpressible."""
    ql = catalog.ql
    if isinstance(expr, TagIs):
        lab = catalog.label_id(expr.field, expr.value)
        return None if lab is None else \
            LabelOrSelector(catalog.label_store, [lab])
    if isinstance(expr, NumRange):
        return _range_selector(catalog, expr)

    if isinstance(expr, (And, Or)):
        tags = [c for c in expr.children if isinstance(c, TagIs)]
        ranges = [c for c in expr.children if isinstance(c, NumRange)]
        if len(tags) + len(ranges) != len(expr.children):
            return None                        # nested And/Or: inexpressible
        labels = [catalog.label_id(t.field, t.value) for t in tags]

        if isinstance(expr, And):
            if any(l is None for l in labels):
                return None                    # unknown tag: matches nothing
            if len(labels) > ql:
                return None                    # exceeds QL exact-verify slots
            rngs = _merge_ranges_and(ranges)
            if any(r.lo >= r.hi for r in rngs):
                return None                    # empty interval
            if len(rngs) > catalog.qr:
                return None                    # exceeds NR predicate slots
            if labels and not rngs:
                return _label_selector(labels, "and", catalog)
            range_sels = [_range_selector(catalog, r) for r in rngs]
            if not labels:
                return range_sels[0] if len(range_sels) == 1 else \
                    AndSelector(range_sels)
            return AndSelector([_label_selector(labels, "and", catalog)]
                               + range_sels)

        # Or — unknown-tag arms match nothing and drop out of the union
        known = [l for l in labels if l is not None]
        if len(known) > ql:
            return None
        if len(ranges) == 0:
            return None if not known else \
                _label_selector(known, "or", catalog)
        if len(ranges) > 1:
            return None                        # unions of multiple ranges
        if not known:
            return _range_selector(catalog, ranges[0])
        return OrSelector([_label_selector(known, "or", catalog),
                           _range_selector(catalog, ranges[0])])
    return None


def eval_mask(expr: FilterExpr | None, catalog) -> tuple[np.ndarray, int]:
    """Exact host evaluation over the attribute indexes.

    Returns ``(mask (N,) bool, pages)`` with the attribute-index pages a
    pre-filter scan of this tree would read.
    """
    n = catalog.n_vectors
    if expr is None:
        return np.ones(n, bool), 0
    if isinstance(expr, TagIs):
        lab = catalog.label_id(expr.field, expr.value)
        mask = np.zeros(n, bool)
        if lab is None:
            return mask, 0
        mask[catalog.label_store.postings(lab)] = True
        return mask, catalog.label_store.posting_pages(lab)
    if isinstance(expr, NumRange):
        ids, pages = catalog.range_store.scan(
            expr.lo, expr.hi, field=catalog.schema.num_index(expr.field))
        mask = np.zeros(n, bool)
        mask[ids] = True
        return mask, pages
    if isinstance(expr, (And, Or)):
        op = np.logical_and if isinstance(expr, And) else np.logical_or
        mask, pages = eval_mask(expr.children[0], catalog)
        for c in expr.children[1:]:
            m, p = eval_mask(c, catalog)
            mask = op(mask, m)
            pages += p
        return mask, pages
    raise TypeError(f"not a FilterExpr: {expr!r}")


def compile_expr(expr: FilterExpr, catalog) -> Selector:
    """Compile a filter expression into an engine Selector.

    Expressible shapes lower onto the built-in algebra (identical plans to
    hand-built selectors); everything else becomes an exact
    ``MaskSelector`` forced down the pre-filtering route.
    """
    if isinstance(expr, (Tag, Num)):
        raise TypeError(f"{expr!r} is a field handle, not an expression — "
                        "compare it (==, .isin, .between, <, >=, …) first")
    if not isinstance(expr, FilterExpr):
        raise TypeError(f"cannot compile {expr!r}")
    _check_fields(expr, catalog)
    sel = _try_builtin(expr, catalog)
    if sel is not None:
        return sel
    mask, pages = eval_mask(expr, catalog)
    return MaskSelector(np.flatnonzero(mask), catalog.n_vectors, pages)
