"""The serving tier of the port: the threaded :class:`SearchServer` with
admission, backpressure and the degrade ladder, and the batched
:class:`RetrievalFrontend`. Counterpart of ``repro.serve`` without its LM
decode scaffolding (ROADMAP queue A, item 8)."""
from repro_torch.serve.retrieval import RetrievalFrontend
from repro_torch.serve.server import SearchServer, ServerConfig, ServerStats

__all__ = ["RetrievalFrontend", "SearchServer", "ServerConfig",
           "ServerStats"]
