"""Filtered-retrieval frontend for the serve path.

Wires the ``repro_torch.api`` Session scheduler into retrieve-then-generate
serving: callers submit (embedding, filter) requests one at a time as
they arrive; the session batches them across callers and flushes by
batch-size/deadline, so concurrent requests share one grouped engine
call (the serving analogue of the paper's query batching, §4).
Counterpart of ``repro.serve.retrieval``, copied.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api.session import PendingSearch, Session, SessionConfig
from repro_torch.api.types import SearchRequest, SearchResult


class RetrievalFrontend:
    """Batched filtered retrieval for serving loops.

    Filters are ``Tag``/``Num`` expressions over the index
    :class:`~repro_torch.api.schema.Schema` — multi-field conjunctions like
    ``(Tag("lang") == "en") & (Num("price") < 50) & (Num("year") >= 2020)``
    compile onto the device verification path; unknown field names fail at
    admission (compile time), not in the flush.
    """

    def __init__(self, index, session_config: SessionConfig = SessionConfig()):
        self.index = index
        self.session = Session(index, session_config)

    @property
    def schema(self):
        """The served index's attribute schema (field discovery for
        request validation / UI layers)."""
        return self.index.schema

    def submit(self, query_embedding: np.ndarray, filter=None,
               k: Optional[int] = None, **overrides) -> PendingSearch:
        """Admit one retrieval request; returns a handle that resolves at
        the next flush (``handle.result()`` forces it)."""
        req = SearchRequest(query=query_embedding, filter=filter, k=k,
                            **overrides)
        return self.session.submit(req)

    def retrieve(self, query_embedding: np.ndarray, filter=None,
                 k: Optional[int] = None, **overrides) -> SearchResult:
        """Synchronous single retrieval (still rides the shared batch)."""
        return self.submit(query_embedding, filter, k, **overrides).result()

    def flush(self) -> int:
        return self.session.flush()

    def poll(self) -> int:
        return self.session.poll()

    @staticmethod
    def context_tokens(result: SearchResult, docs: np.ndarray,
                       per_doc: int = 8) -> np.ndarray:
        """Concatenate the leading tokens of each retrieved doc — the
        prompt-context assembly used by the RAG example."""
        hit_ids = [i for i, _, _ in result.matches]
        if not hit_ids:
            return np.zeros(per_doc, np.int64)
        return np.concatenate([np.asarray(docs[h][:per_doc]) for h in hit_ids])
