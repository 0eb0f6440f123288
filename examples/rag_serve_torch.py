"""RAG-style serving on the PyTorch port: filtered vector retrieval (the
paper's engine) feeding a decoder-only LM (the port of
examples/rag_serve.py).

A corpus of synthetic "documents" is embedded (stub projector) and indexed
through the ``repro_torch.api`` facade from plain metadata dicts (topic
label + freshness value). Requests are admitted one at a time to a batched
retrieval frontend (``serve.retrieval``): the session groups them across
callers and flushes once, so all four retrievals share one grouped engine
call before generation.

    PYTHONPATH=src python examples/rag_serve_torch.py               # card
    PYTHONPATH=src python examples/rag_serve_torch.py --device cpu

``main`` returns each request's topic, matches and generated tokens.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.api import Index, IndexConfig, Num, SearchConfig, Tag
from repro_torch.api.session import SessionConfig
from repro_torch.configs import smoke_config
from repro_torch.models import lm
from repro_torch.serve import RetrievalFrontend, generate


def embed_docs(docs: np.ndarray, d_embed: int, seed: int = 0) -> np.ndarray:
    """Stub embedding: random projection of token histograms."""
    rng = np.random.default_rng(seed)
    vocab = int(docs.max()) + 1
    proj = rng.normal(0, 1 / np.sqrt(vocab), (vocab, d_embed))
    hist = np.zeros((len(docs), vocab), np.float32)
    for i, doc in enumerate(docs):
        np.add.at(hist[i], doc, 1.0)
    return (hist @ proj).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=2000,
                    help="corpus size (documents)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n_docs, doc_len, vocab = args.docs, 24, 512
    docs = rng.integers(0, vocab, (n_docs, doc_len))
    topics = rng.integers(0, 20, n_docs)                 # one topic label
    freshness = rng.uniform(0, 100, n_docs).astype(np.float32)

    # index the corpus from plain metadata dicts
    embeds = embed_docs(docs, d_embed=32)
    metadata = [{"topic": int(t), "freshness": float(f)}
                for t, f in zip(topics, freshness)]
    index = Index.build(embeds, metadata,
                        IndexConfig(r=16, r_dense=160, l_build=32, pq_m=8),
                        defaults=SearchConfig(k=4, l=24), device=args.device)
    print(f"indexed {n_docs} docs")

    # a tiny LM as the generator
    cfg = dataclasses.replace(smoke_config("qwen2-1.5b"), vocab=vocab)
    params = lm.init_lm(cfg, 0, args.device)

    # serve a batch of filtered retrieve->generate requests: admit all four
    # to the frontend, then flush once — one grouped engine call
    frontend = RetrievalFrontend(
        index, SessionConfig(max_batch=8, max_delay_s=10.0))
    queries = embed_docs(docs[rng.integers(0, n_docs, 4)], 32, seed=1)
    req_topics = [int(rng.integers(0, 20)) for _ in range(4)]
    handles = [
        frontend.submit(queries[i],
                        (Tag("topic") == t) &
                        Num("freshness").between(25.0, 90.0))
        for i, t in enumerate(req_topics)]
    n = frontend.flush()
    print(f"flushed {n} requests in {frontend.session.n_batches} batch")

    answers = []
    for i, (topic, h) in enumerate(zip(req_topics, handles)):
        res = h.result()
        # verify the filter held against the source arrays (ground truth,
        # independent of the index's own metadata resolution)
        assert all(topics[j] == topic and 25 <= freshness[j] < 90
                   for j, _, _ in res.matches)
        assert all(m["topic"] == topic for _, _, m in res.matches)
        context = RetrievalFrontend.context_tokens(res, docs, per_doc=8)
        prompt = np.concatenate([context, docs[0][:8]])[None, :] \
            .astype(np.int32)
        out = generate(params, cfg, prompt, n_new=8).cpu().numpy()
        hit_ids = [j for j, _, _ in res.matches]
        print(f"req {i}: topic={topic} mech={res.stats.mechanism} "
              f"retrieved={hit_ids} io={res.stats.io_pages} "
              f"generated={out[0].tolist()}")
        answers.append({"topic": topic, "matches": hit_ids,
                        "generated": out[0].tolist()})
    print("all retrievals satisfied their attribute constraints")
    return {"flushed": n, "batches": frontend.session.n_batches,
            "answers": answers}


if __name__ == "__main__":
    main()
