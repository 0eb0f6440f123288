"""Synthetic data: filtered-ANNS datasets (numpy, same RNG stream as
``repro``), the motif token stream of the LM trainer and its host
prefetcher."""
