"""Tiered record storage: page-aligned slab files, a clock page cache,
and bloom-gated reads with measured per-page latency (counterpart of
``repro.storage``).
"""
from repro_torch.storage.cache import PageCache
from repro_torch.storage.disk import DiskRecordStore, StorageConfig
from repro_torch.storage.slab import (InjectedReadError, SlabChecksumError,
                                      SlabLayout, read_meta, write_slab_file)

__all__ = ["PageCache", "DiskRecordStore", "StorageConfig",
           "InjectedReadError", "SlabChecksumError", "SlabLayout",
           "read_meta", "write_slab_file"]
