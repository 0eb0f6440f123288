"""Synthetic filtered-ANNS datasets (numpy, same RNG stream as ``repro``)."""
