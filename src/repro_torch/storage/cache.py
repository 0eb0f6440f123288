"""Clock page cache for the disk record tier (counterpart of
``repro.storage.cache``: the same frames, clock and counters).

Frames are whole 4 KB pages keyed by *global page index* (record slab ×
page-in-slab); eviction is the classic second-chance clock — a hit sets
the frame's reference bit, the hand clears bits until it finds a cold
frame. Pages brought in by read-ahead carry a provenance flag so the
``readahead_hits`` counter can tell a useful prefetch from a wasted one
(the flag clears on first demand hit).

Correctness never depends on the cache: a frame holds the exact bytes of
its page, so any eviction order returns bit-identical data — property-
tested in tests/test_torch_storage.py by sweeping capacities from
eviction-heavy to all-resident.
"""
from __future__ import annotations


class PageCache:
    def __init__(self, capacity_pages: int):
        self.capacity = max(1, int(capacity_pages))
        self._frames: dict = {}     # page id -> [bytes, ref, readahead]
        self._ring: list = []       # clock order of page ids (may go stale)
        self._hand = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.readahead_hits = 0

    def __len__(self) -> int:
        return len(self._frames)

    def get(self, pid: int):
        """Cached page bytes or None (counts the hit/miss)."""
        f = self._frames.get(pid)
        if f is None:
            self.misses += 1
            return None
        self.hits += 1
        f[1] = True
        if f[2]:                    # first demand hit on a prefetched page
            self.readahead_hits += 1
            f[2] = False
        return f[0]

    def contains(self, pid: int) -> bool:
        """Presence probe without touching counters or ref bits."""
        return pid in self._frames

    def put(self, pid: int, data: bytes, readahead: bool = False):
        f = self._frames.get(pid)
        if f is not None:           # refresh in place, keep clock position
            f[0] = data
            return
        while len(self._frames) >= self.capacity:
            self._evict_one()
        self._frames[pid] = [data, not readahead, readahead]
        self._ring.append(pid)

    def _evict_one(self):
        # second-chance sweep; invalidated ids linger in the ring as stale
        # entries and are reaped (slot reused) as the hand passes them
        while True:
            if not self._ring:      # all frames invalidated underneath us
                return
            self._hand %= len(self._ring)
            pid = self._ring[self._hand]
            f = self._frames.get(pid)
            if f is None:           # stale ring slot — reap it
                self._ring.pop(self._hand)
                continue
            if f[1]:
                f[1] = False
                self._hand += 1
                continue
            del self._frames[pid]
            self._ring.pop(self._hand)
            self.evictions += 1
            return

    def invalidate(self, pids) -> None:
        """Drop pages (e.g. after a failed/corrupted read attempt, so the
        retry goes back to the device instead of re-serving bad frames)."""
        for pid in pids:
            self._frames.pop(pid, None)

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "readahead_hits": self.readahead_hits,
                "resident_pages": len(self._frames),
                "capacity_pages": self.capacity}
