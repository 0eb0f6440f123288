"""The unified public query layer of the port: a schema-first metadata
surface, declarative filters compiled onto the speculative-filtering
engine, a metadata-dict index facade, and a batched session scheduler.
Counterpart of ``repro.api``, with the same public names."""
from repro_torch.api.filters import (And, FilterExpr, Num, NumRange, Or, Tag,
                                     TagIs, compile_expr)
from repro_torch.api.index import Index
from repro_torch.api.schema import Schema, UnknownFieldError
from repro_torch.api.session import PendingSearch, Session, SessionConfig
from repro_torch.api.types import (DeadlineExceeded, Overloaded,
                                   RequestStats, SearchRequest, SearchResult,
                                   ServeError)
from repro_torch.core.engine import IndexConfig, SearchConfig, recall_at_k

__all__ = [
    "And", "FilterExpr", "Num", "NumRange", "Or", "Tag", "TagIs",
    "compile_expr", "Index", "IndexConfig", "SearchConfig",
    "Schema", "UnknownFieldError",
    "PendingSearch", "Session", "SessionConfig",
    "RequestStats", "SearchRequest", "SearchResult", "recall_at_k",
    "ServeError", "Overloaded", "DeadlineExceeded",
]
