"""Page-aligned slab files: the real on-disk record tier.

Counterpart of ``repro.storage.slab``: the same layout, codec and meta JSON,
so a slab file written by either package is byte-equal to the other's and
opens in both.

One record occupies one *slab* — a fixed run of 4 KB pages whose layout
mirrors the modeled record of ``core/records.py`` (paper §4.1):

    std block  (pages [0, std_pages))       dense block (pages [std_pages, ..))
    ┌──────────┬───────────┬─── slack ──┬──────┐ ┌──────────────────┬───────┐
    │ vector   │ neighbors │            │ tail │ │ dense neighbors  │ crc_d │
    └──────────┴───────────┴────────────┴──────┘ └──────────────────┴───────┘
                              tail = labels | values | cand_first bits
                                     | crc_std | crc_tail

Attributes ride in the **final-page slack of the std block**, so exact
verification costs no extra page beyond the record fetch, and a
strict-mode attribute probe touches exactly one page (the std block's
last). A standard fetch reads the std block; a densified fetch reads the
whole slab; both end on a CRC32 check per region, which is what turns an
injected bit-flip into a *detected* checksum failure that re-enters the
retry ladder (docs/robustness.md).

The physical page counts here (``std_pages`` / ``slab_pages``) may differ
by ±1 from the modeled ``RecordStore.pages_std/pages_dense`` (the model
packs count-prefixed fields contiguously; the file aligns the dense block
to a page boundary). Search counters keep the modeled accounting — that
is what bit-identity with the in-memory backend requires — while the disk
tier reports its own *measured* page reads alongside.
"""
from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np

from repro_torch.core.io_sim import PAGE_BYTES

SLAB_FILE = "records.slab"
META_FILE = "slab_meta.json"
_FORMAT = 1


class SlabChecksumError(IOError):
    """A slab region failed its CRC32 — corrupted read."""


class InjectedReadError(IOError):
    """A fault-plan draw failed this read attempt before completion."""


class SlabLayout:
    """Byte/page geometry of one slab, derived from the field widths."""

    def __init__(self, dim: int, r: int, r_dense: int, max_labels: int,
                 n_fields: int, page_bytes: int = PAGE_BYTES):
        self.dim, self.r, self.r_dense = dim, r, r_dense
        self.max_labels, self.n_fields = max_labels, n_fields
        self.page_bytes = page_bytes
        self.vec_bytes = dim * 4
        self.nbr_bytes = r * 4
        self.cf_bytes = math.ceil((r + r_dense) / 8)
        # tail: labels | values | cand_first bits | crc_std | crc_tail
        self.tail_bytes = (max_labels * 4 + n_fields * 4 + self.cf_bytes
                           + 4 + 4)
        assert self.tail_bytes <= page_bytes, \
            "attribute tail must fit one page (final-page slack layout)"
        head = self.vec_bytes + self.nbr_bytes
        self.std_pages = max(1, math.ceil((head + self.tail_bytes)
                                          / page_bytes))
        self.std_bytes = self.std_pages * page_bytes
        self.tail_off = self.std_bytes - self.tail_bytes
        # dense block: ids + trailing crc, page-aligned after the std block
        self.dense_bytes_payload = r_dense * 4 + 4
        self.dense_pages = (math.ceil(self.dense_bytes_payload / page_bytes)
                            if r_dense > 0 else 0)
        self.slab_pages = self.std_pages + self.dense_pages
        self.slab_bytes = self.slab_pages * page_bytes
        self.attr_page = self.std_pages - 1    # the one page a probe reads

    def to_json(self) -> dict:
        return {"dim": self.dim, "r": self.r, "r_dense": self.r_dense,
                "max_labels": self.max_labels, "n_fields": self.n_fields,
                "page_bytes": self.page_bytes}

    @classmethod
    def from_json(cls, d: dict) -> "SlabLayout":
        return cls(d["dim"], d["r"], d["r_dense"], d["max_labels"],
                   d["n_fields"], d.get("page_bytes", PAGE_BYTES))


def _unpack_bits(raw: bytes, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")
    return bits[:n].astype(bool)


def decode_std(layout: SlabLayout, blk: bytes) -> dict:
    """std block bytes → field arrays. Raises :class:`SlabChecksumError`
    on a CRC mismatch (the genuine corruption-detection path)."""
    lo = layout
    head = blk[:lo.vec_bytes + lo.nbr_bytes]
    tail = blk[lo.tail_off:lo.tail_off + lo.tail_bytes]
    crc_std, crc_tail = np.frombuffer(tail[-8:], np.uint32)
    if zlib.crc32(head) & 0xFFFFFFFF != crc_std:
        raise SlabChecksumError("std-block checksum mismatch")
    if zlib.crc32(tail[:-8]) & 0xFFFFFFFF != crc_tail:
        raise SlabChecksumError("tail checksum mismatch")
    off = 0
    vec = np.frombuffer(head, np.float32, lo.dim, off); off += lo.vec_bytes
    nbrs = np.frombuffer(head, np.int32, lo.r, off)
    t = 0
    labels = np.frombuffer(tail, np.int32, lo.max_labels, t)
    t += lo.max_labels * 4
    values = np.frombuffer(tail, np.float32, lo.n_fields, t)
    t += lo.n_fields * 4
    cf = _unpack_bits(tail[t:t + lo.cf_bytes], lo.r + lo.r_dense)
    return {"vector": vec, "neighbors": nbrs, "rec_labels": labels,
            "rec_values": values, "cand_first": cf}


def decode_dense(layout: SlabLayout, blk: bytes) -> np.ndarray:
    """dense block bytes → (r_dense,) int32 ids, CRC-checked."""
    lo = layout
    pay = blk[:lo.r_dense * 4]
    crc = np.frombuffer(blk, np.uint32, 1, lo.r_dense * 4)[0]
    if zlib.crc32(pay) & 0xFFFFFFFF != crc:
        raise SlabChecksumError("dense-block checksum mismatch")
    return np.frombuffer(pay, np.int32, lo.r_dense)


def decode_attrs(layout: SlabLayout, page: bytes) -> dict:
    """The attr page (std block's last) → labels/values, CRC-checked."""
    lo = layout
    off = lo.tail_off - (lo.attr_page * lo.page_bytes)
    tail = page[off:off + lo.tail_bytes]
    crc_tail = np.frombuffer(tail[-8:], np.uint32)[1]
    if zlib.crc32(tail[:-8]) & 0xFFFFFFFF != crc_tail:
        raise SlabChecksumError("tail checksum mismatch")
    labels = np.frombuffer(tail, np.int32, lo.max_labels, 0)
    values = np.frombuffer(tail, np.float32, lo.n_fields, lo.max_labels * 4)
    return {"rec_labels": labels, "rec_values": values}


ENCODE_CHUNK = 4096     # records encoded per numpy block by write_slab_file


def encode_slabs(layout: SlabLayout, vectors: np.ndarray, nbrs: np.ndarray,
                 dense: np.ndarray, labels: np.ndarray, values: np.ndarray,
                 cand_first: np.ndarray) -> np.ndarray:
    """A block of records → (m, slab_bytes) uint8, one page-aligned slab a
    row (std block + dense block): the fields are laid into place as numpy
    views, and only the CRC32s are taken record by record."""
    lo = layout
    m = vectors.shape[0]
    buf = np.zeros((m, lo.slab_bytes), np.uint8)

    def put(off: int, a, dtype) -> int:
        b = np.ascontiguousarray(a, dtype).reshape(m, -1).view(np.uint8)
        buf[:, off:off + b.shape[1]] = b
        return off + b.shape[1]

    head = put(put(0, vectors, np.float32), nbrs, np.int32)
    t = lo.tail_off
    end = put(put(t, labels, np.int32), values, np.float32)
    bits = np.packbits(np.asarray(cand_first, bool).reshape(m, -1), axis=1,
                       bitorder="little")
    buf[:, end:end + bits.shape[1]] = bits
    crc_at = t + lo.tail_bytes - 8
    dpay = lo.r_dense * 4
    if lo.r_dense > 0:
        put(lo.std_bytes, dense, np.int32)
    crcs = np.zeros((m, 3), np.uint32)
    for i in range(m):
        row = buf[i]
        crcs[i, 0] = zlib.crc32(row[:head])
        crcs[i, 1] = zlib.crc32(row[t:crc_at])
        if lo.r_dense > 0:
            crcs[i, 2] = zlib.crc32(row[lo.std_bytes:lo.std_bytes + dpay])
    buf[:, crc_at:crc_at + 8] = crcs[:, :2].view(np.uint8)
    if lo.r_dense > 0:
        at = lo.std_bytes + dpay
        buf[:, at:at + 4] = crcs[:, 2:].view(np.uint8)
    return buf


def write_slab_file(path: str, vectors: np.ndarray, neighbors: np.ndarray,
                    dense_neighbors: np.ndarray, rec_labels: np.ndarray,
                    rec_values: np.ndarray, cand_first: np.ndarray,
                    pages_std: int, pages_dense: int,
                    page_bytes: int = PAGE_BYTES) -> SlabLayout:
    """Write every record's slab plus the sidecar meta JSON, in blocks of
    ``ENCODE_CHUNK`` records (:func:`encode_slabs`).

    ``pages_std``/``pages_dense`` are the *modeled* per-fetch page counts
    (``RecordStore``); they ride the meta so a reopened store can rebuild
    the search-visible accounting without the original arrays.
    """
    n, dim = vectors.shape
    layout = SlabLayout(dim, neighbors.shape[1], dense_neighbors.shape[1],
                        rec_labels.shape[1], rec_values.shape[1], page_bytes)
    slab_path = os.path.join(path, SLAB_FILE)
    os.makedirs(path, exist_ok=True)
    with open(slab_path, "wb") as f:
        for s in range(0, n, ENCODE_CHUNK):
            e = min(n, s + ENCODE_CHUNK)
            f.write(encode_slabs(layout, vectors[s:e], neighbors[s:e],
                                 dense_neighbors[s:e], rec_labels[s:e],
                                 rec_values[s:e], cand_first[s:e]))
    meta = {"format": _FORMAT, "n": int(n), "layout": layout.to_json(),
            "pages_std": int(pages_std), "pages_dense": int(pages_dense),
            "slab_bytes": layout.slab_bytes,
            "file_bytes": n * layout.slab_bytes}
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return layout


def read_meta(path: str) -> dict:
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)
