"""The serving tier of the port: the threaded :class:`SearchServer` with
admission, backpressure and the degrade ladder, the batched
:class:`RetrievalFrontend`, and the LM's prefill/decode entry points
(``generate``, ``make_prefill``, ``make_decode_step``) that retrieval feeds.
Counterpart of ``repro.serve``."""
from repro_torch.serve.decode import generate, make_decode_step, make_prefill
from repro_torch.serve.retrieval import RetrievalFrontend
from repro_torch.serve.server import SearchServer, ServerConfig, ServerStats

__all__ = ["generate", "make_decode_step", "make_prefill",
           "RetrievalFrontend", "SearchServer", "ServerConfig",
           "ServerStats"]
