"""The end-to-end system: Vamana+PQ index build and filtered search.

The entry point is :class:`repro_torch.core.engine.FilteredANNEngine`.
"""
