"""Quickstart on the PyTorch port: build a filtered vector index from plain
metadata dicts and query it through the declarative, schema-first
``repro_torch.api`` surface (the port of examples/quickstart.py).

The index is built from per-record metadata against an explicit ``Schema``
with two numeric fields; filters are `Tag`/`Num` expressions compiled onto
the paper's three mechanisms, routed per query by the cost model.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``main`` returns each query's route and recall@10 and whether the
inserted record was found.
"""
import argparse

import numpy as np

from repro_torch.api import (Index, IndexConfig, Num, Schema, SearchConfig,
                             SearchRequest, Tag, recall_at_k)
from repro_torch.data.synth import make_filtered_dataset


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4000, help="corpus size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    print("== PipeANN-Filter quickstart (PyTorch port) ==")
    ds = make_filtered_dataset(n=args.n, d=32, n_queries=8, n_labels=50,
                               seed=1)

    # plain per-record metadata dicts: topic tags + two numeric fields
    # (freshness from the dataset, price synthesized here)
    rng = np.random.default_rng(3)
    prices = rng.lognormal(3.0, 0.7, len(ds.vectors)).astype(np.float32)
    metadata = [
        {**d, "price": float(p)}
        for d, p in zip(ds.metadata(tag_field="topic", num_field="freshness"),
                        prices)
    ]
    schema = Schema(tags=["topic"], nums=["freshness", "price"])
    index = Index.build(ds.vectors, metadata,
                        IndexConfig(r=20, r_dense=200, l_build=40, pq_m=8),
                        schema=schema, defaults=SearchConfig(k=10, l=32),
                        device=args.device)
    e = index.engine
    print(f"built index: N={len(index)} R={e.store.degree} "
          f"R_d={e.store.dense_degree} schema={schema.tags}+{schema.nums} "
          f"pages/record std={e.store.pages_std} "
          f"dense={e.store.pages_dense}")

    # alternate single-field filters with a tag ∧ two-numeric-field AND
    requests = []
    for i in range(8):
        if i % 3 == 0:
            f = Tag("topic") == int(ds.query_labels[i][0])
        elif i % 3 == 1:
            lo, hi = ds.query_ranges[i]
            f = Num("freshness").between(float(lo), float(hi))
        else:
            lo, hi = ds.query_ranges[i]
            f = ((Tag("topic") == int(ds.query_labels[i][0]))
                 & Num("freshness").between(float(lo), float(hi))
                 & (Num("price") < 40.0))
        requests.append(SearchRequest(query=ds.queries[i], filter=f))

    results = index.search_batch(requests)
    recalls = []
    for i, (req, res) in enumerate(zip(requests, results)):
        r = recall_at_k(res.ids, index.ground_truth(req), 10)
        recalls.append(r)
        print(f"query {i}: mech={res.stats.mechanism:4s} "
              f"sel={res.stats.selectivity:.4f} io={res.stats.io_pages:4d} "
              f"recall@10={r:.2f}")
    mechs = [r.stats.mechanism for r in results]
    print("routes:", {m: mechs.count(m) for m in set(mechs)})

    # streaming inserts: append fresh records and query them immediately
    rng = np.random.default_rng(7)
    new_vecs = ds.vectors[:16] + rng.normal(0, 0.01, (16, 32)) \
        .astype(np.float32)
    new_meta = [{"topic": "breaking", "freshness": 99.0, "price": 12.5}
                for _ in range(16)]
    new_ids = index.insert(new_vecs, new_meta)
    res = index.search(SearchRequest(
        query=new_vecs[0],
        filter=(Tag("topic") == "breaking") & (Num("price") < 20.0), k=5))
    hit = int(new_ids[0]) in res.ids.tolist()
    print(f"inserted {len(new_ids)} records (ids {new_ids[0]}..{new_ids[-1]});"
          f" nearest under its new tag ∧ price filter found={hit}")
    return {"mechanisms": mechs, "recalls": recalls,
            "inserted": [int(i) for i in new_ids], "insert_found": hit}


if __name__ == "__main__":
    main()
