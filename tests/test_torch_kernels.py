"""The port's kernel plain versions against the JAX package's Pallas kernels
(interpret mode) and its jnp references, on the shape grids of
tests/test_kernels.py; integers and bools exact, the hop_fused key bitwise.

``l2_rerank`` is held with a tolerance: its sums run in another order than
XLA's. The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds each against its plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_port_helpers import (PRUNE_KINDS, gather_inputs, gathered_slab,
                                hop_inputs, or_inputs, prune_edge_inputs,
                                prune_inputs)


# ---------------------------------------------------------------------------
# hop_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c", [(1, 7), (3, 64), (4, 300), (2, 520)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hop_fused_matches_repro(b, c, seed):
    rng = np.random.default_rng(seed * 100 + b * c)
    args = hop_inputs(rng, b, c)
    key_t, ok_t = tops.hop_fused(*(torch.from_numpy(a) for a in args))
    jargs = [jnp.asarray(a) for a in args]
    key_i, ok_i = jops.hop_fused_interpret(*jargs)
    key_r, ok_r = jref.hop_fused_ref(*jargs)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_r))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_i))
    # the key bit for bit: the ADC sum runs m left to right in all three
    np.testing.assert_array_equal(key_t.numpy().view(np.int32),
                                  np.asarray(key_r).view(np.int32))
    np.testing.assert_array_equal(key_t.numpy().view(np.int32),
                                  np.asarray(key_i).view(np.int32))


@pytest.mark.parametrize("lo", [0, 1])
def test_hop_fused_out_of_range_field_matches_repro(lo):
    """A range slot naming field F (past the last bucket column) reads 0 in
    the Pallas kernel; the plain version does the same. (``repro``'s jnp
    reference gathers with JAX's out-of-bounds fill instead, so it is not
    the oracle for this case.)"""
    rng = np.random.default_rng(11 + lo)
    args = list(hop_inputs(rng, 3, 64))
    f = args[2].shape[-1]
    args[7] = np.where(rng.random(args[7].shape) < 0.5, f,
                       args[7]).astype(np.int32)
    args[7][:, 0] = f
    args[8] = np.full_like(args[8], lo)                   # 0 passes, 1 fails
    key_t, ok_t = tops.hop_fused(*(torch.from_numpy(a) for a in args))
    key_i, ok_i = jops.hop_fused_interpret(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_i))
    np.testing.assert_array_equal(key_t.numpy().view(np.int32),
                                  np.asarray(key_i).view(np.int32))


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("c", [7, 512])
@pytest.mark.parametrize("merged_mode", [0, 1, 2])
def test_hop_fused_gather_matches_repro(b, c, merged_mode):
    """The gathered entry on the CPU against ``repro``'s Pallas kernel
    (interpret mode) and jnp reference, both run on the slab gathered with
    numpy from the same stores; ids include 0, N-1 and repeats."""
    rng = np.random.default_rng(b * 1000 + c + merged_mode)
    n = 1000
    args = gather_inputs(rng, b, c, n, m=16, merged_mode=merged_mode)
    key_t, ok_t = tops.hop_fused_gather(*(torch.from_numpy(a)
                                          for a in args))
    jargs = [jnp.asarray(a) for a in gathered_slab(args)]
    key_i, ok_i = jops.hop_fused_interpret(*jargs)
    key_r, ok_r = jref.hop_fused_ref(*jargs)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_i))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_r))
    np.testing.assert_array_equal(key_t.numpy().view(np.int32),
                                  np.asarray(key_i).view(np.int32))
    np.testing.assert_array_equal(key_t.numpy().view(np.int32),
                                  np.asarray(key_r).view(np.int32))


def test_hop_fused_gather_out_of_range_ids():
    """An id outside [0, N) reads no row and gives key +inf, ok False; the
    other candidates are those of the slab entry; a bitmap too short for
    the stores is refused."""
    rng = np.random.default_rng(21)
    args = [torch.from_numpy(a) for a in gather_inputs(rng, 2, 9, 50)]
    ids = args[4].clone()
    ids[0, 3], ids[1, 0], ids[1, 8] = -1, 50, 2 ** 31 - 1
    args[4] = ids
    key, ok = tops.hop_fused_gather(*args)
    bad = (ids < 0) | (ids >= 50)
    assert torch.isinf(key[bad]).all() and not ok[bad].any()
    safe = [a.numpy() for a in args]
    safe[4] = np.where(bad.numpy(), 0, safe[4])
    key_s, ok_s = tops.hop_fused(*(torch.from_numpy(a)
                                   for a in gathered_slab(safe)))
    assert torch.equal(key[~bad], key_s[~bad])
    assert torch.equal(ok[~bad], ok_s[~bad])
    with pytest.raises(ValueError, match="bitmap words"):
        tops.hop_fused_gather(*args[:3], args[3][:, :1], *args[4:])


@pytest.mark.parametrize("m", [32, 48, 64])
def test_hop_fused_wide_tables_match_repro(m):
    """Both entries take the wide tables of 768-d vectors (M = 64, a 64 KB
    table a query) and those either side of it, bit for bit against
    ``repro``'s Pallas kernel (interpret mode) on the same slab."""
    rng = np.random.default_rng(m)
    args = gather_inputs(rng, 3, 40, 300, m=m)
    key_g, ok_g = tops.hop_fused_gather(*(torch.from_numpy(a)
                                          for a in args))
    slab = gathered_slab(args)
    key_s, ok_s = tops.hop_fused(*(torch.from_numpy(a) for a in slab))
    key_i, ok_i = jops.hop_fused_interpret(*[jnp.asarray(a) for a in slab])
    for key, ok in ((key_g, ok_g), (key_s, ok_s)):
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_i))
        np.testing.assert_array_equal(key.numpy().view(np.int32),
                                      np.asarray(key_i).view(np.int32))


def test_tables_past_the_opt_in_limit_are_refused():
    """The card's entries stage a query's (M, K) table in shared memory up
    to the opt-in limit: M = 64 at K = 256 passes their checks, a table
    past the limit raises ValueError (checked here on CPU tensors, as the
    CUDA path checks them before a launch)."""
    cpu = torch.device("cpu")
    limit = tops.SMEM_OPTIN_BYTES
    for m, k, fits in ((64, 256, True), (56, 1024, True),
                       (57, 1024, False), (64, 1024, False)):
        hop_fits = tops.HF_TABLE_OFFSET + m * k * 4 <= limit
        pq_fits = m * k * 4 <= limit
        assert hop_fits == pq_fits == fits, (m, k)
        b, nr = 2, 4
        params = (torch.zeros((b, m, k)),
                  torch.zeros((b, 4), dtype=torch.int32),
                  torch.zeros((b, 8), dtype=torch.int32),
                  *(torch.zeros((b, nr), dtype=torch.int32),) * 3)
        codes = torch.zeros((5, m), dtype=torch.uint8)
        table = torch.zeros((m, k))
        if fits:
            tops._check_hop_params(b, m, *params, cpu)
            assert tops._check_pq(codes, table, cpu) == "u8"
            continue
        with pytest.raises(ValueError, match="bytes of shared memory"):
            tops._check_hop_params(b, m, *params, cpu)
        with pytest.raises(ValueError, match="bytes of shared memory"):
            tops._check_pq(codes, table, cpu)


def test_adc_slab_matches_repro():
    rng = np.random.default_rng(5)
    for m in (8, 16):
        codes = rng.integers(0, 256, (3, 200, m)).astype(np.uint8)
        table = (rng.normal(0, 1, (3, m, 256)) ** 2).astype(np.float32)
        got = tref.adc_slab_ref(torch.from_numpy(codes),
                                torch.from_numpy(table)).numpy()
        want = np.asarray(jref.adc_slab_ref(jnp.asarray(codes),
                                            jnp.asarray(table)))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


# ---------------------------------------------------------------------------
# or_scatter
# ---------------------------------------------------------------------------

def _or_scatter_numpy(words, slots):
    out = np.asarray(words, np.int32).copy()
    n_bits = out.shape[1] * 32
    for b, row in enumerate(np.asarray(slots)):
        for s in row:
            if 0 <= s < n_bits:
                out[b, s >> 5] |= np.int32(1) << np.int32(s & 31)
    return out


@pytest.mark.parametrize("b,nw,c", [(1, 1, 4), (3, 8, 33), (7, 4, 128),
                                    (2, 32, 300)])
@pytest.mark.parametrize("seed", [0, 1])
def test_or_scatter_matches_repro(b, nw, c, seed):
    words, slots = or_inputs(b, nw, c, seed)
    got = tops.or_scatter(torch.from_numpy(words),
                          torch.from_numpy(slots)).numpy()
    np.testing.assert_array_equal(got, _or_scatter_numpy(words, slots))
    np.testing.assert_array_equal(got, np.asarray(jops.or_scatter_interpret(
        jnp.asarray(words), jnp.asarray(slots))))
    np.testing.assert_array_equal(got, np.asarray(jref.or_scatter_ref(
        jnp.asarray(words), jnp.asarray(slots))))


def test_or_scatter_idempotent_and_sign_bit():
    words = torch.zeros((2, 2), dtype=torch.int32)
    slots = torch.tensor([[31, 31, 0, 32, 0], [-1, 64, 64, 100, -5]],
                         dtype=torch.int32)
    want = np.array([[np.int32(1) << 31 | 1, 1], [0, 0]], np.int32)
    got = tops.or_scatter(words, slots)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.or_scatter(got, slots).numpy(), want)


def _edge_ids(rng, b, nw, c):
    """Ids over [-8, NW*32 + 8) with the edge lanes forced in: a negative
    id, a duplicate, bit 31 of the last word and one id past the table."""
    ids = rng.integers(-8, nw * 32 + 8, (b, c)).astype(np.int32)
    edges = [-1, 5, 5, nw * 32 - 1, nw * 32]
    k = min(c, len(edges))
    ids[:, :k] = np.array(edges[:k], np.int32)
    return ids


def _repro_or_scatter(words, slots):
    """``repro``'s interpret kernel and jnp reference, which must agree
    (with no slot, C = 0, the reference alone: the Pallas interpreter cannot
    run a zero-width block)."""
    w, s = jnp.asarray(words), jnp.asarray(slots)
    want = np.asarray(jref.or_scatter_ref(w, s))
    if slots.shape[-1]:
        np.testing.assert_array_equal(
            np.asarray(jops.or_scatter_interpret(w, s)), want)
    return want


@pytest.mark.parametrize("c", [1, 32, 2048])
@pytest.mark.parametrize("nw", [1, 8, 1000])
@pytest.mark.parametrize("b", [1, 3, 64])
def test_or_scatter_inplace_matches_repro(b, nw, c):
    """The in-place entry sets what ``repro``'s out-of-place kernel sets,
    in the very tensor it was given."""
    rng = np.random.default_rng(b * 7919 + nw * 31 + c)
    words = rng.integers(-2 ** 31, 2 ** 31, (b, nw),
                         dtype=np.int64).astype(np.int32)
    ids = _edge_ids(rng, b, nw, c)
    want = _repro_or_scatter(words, ids)
    t = torch.from_numpy(words.copy())
    ptr = t.data_ptr()
    got = tops.or_scatter_(t, torch.from_numpy(ids))
    assert got is t and got.data_ptr() == ptr
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("n_ids", [2 ** 20, 2 ** 20 + 1, 3 * 2 ** 20])
def test_or_scatter_visited_slots_match_repro(n_ids):
    """With ``n_ids`` both new entries set ``repro``'s visited slots
    (``core/search.py`` ``_visited_slot``: identity up to 2^20 ids, the
    uint32 multiply-shift hash beyond), negative ids dropped."""
    from repro.core import search as jsearch
    n_slots, _ = jsearch._visited_spec(n_ids)
    assert (n_slots, tref.visited_spec(n_ids)[0]) == (2 ** 20, 2 ** 20)
    nw = n_slots // 32
    rng = np.random.default_rng(n_ids)
    b, c = 3, 64
    words = rng.integers(-2 ** 31, 2 ** 31, (b, nw),
                         dtype=np.int64).astype(np.int32)
    ids = rng.integers(-4, n_ids, (b, c)).astype(np.int32)
    ids[:, :3] = [-1, n_ids - 1, 2 ** 31 - 1]
    jids = jnp.asarray(ids)
    slots = np.asarray(jnp.where(
        jids >= 0, jsearch._visited_slot(jnp.where(jids >= 0, jids, 0),
                                         n_ids), n_slots))
    want = _repro_or_scatter(words, slots)
    t = torch.from_numpy(words.copy())
    tops.or_scatter_(t, torch.from_numpy(ids), n_ids)
    np.testing.assert_array_equal(t.numpy(), want)
    fresh = _repro_or_scatter(np.zeros_like(words), slots)
    np.testing.assert_array_equal(
        tops.or_scatter_new(torch.from_numpy(ids), nw, n_ids).numpy(), fresh)


@pytest.mark.parametrize("b,nw,c", [(1, 1, 0), (3, 7, 0), (3, 7, 5),
                                    (2, 1001, 300), (4, 31251, 2048),
                                    (2, 8193, 64)])
def test_or_scatter_new_matches_repro(b, nw, c):
    """The fresh-table entry equals ``repro``'s kernel on a zero table: odd
    widths (31,251 words: the rare list at N = 1M), C = 0, and the rare
    list's sentinel bit n_ids, which lies inside the table."""
    rng = np.random.default_rng(b * nw + c)
    ids = _edge_ids(rng, b, nw, c) if c else np.zeros((b, 0), np.int32)
    n_ids = nw * 32 - 33                     # a rare list over n_ids ids
    if c > 5:
        ids[:, -1] = n_ids                   # the sentinel (a clipped pad)
    want = _repro_or_scatter(np.zeros((b, nw), np.int32), ids)
    got = tops.or_scatter_new(torch.from_numpy(ids), nw)
    assert got.dtype == torch.int32 and got.shape == (b, nw)
    np.testing.assert_array_equal(got.numpy(), want)
    if c > 5:
        assert (want[:, n_ids >> 5] >> (n_ids & 31) & 1).all()


# ---------------------------------------------------------------------------
# prune_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c,r", [(1, 16, 4), (8, 48, 12), (5, 96, 32),
                                   (2, 33, 5)])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_prune_scan_matches_repro(b, c, r, alpha):
    rng = np.random.default_rng(b * c + r)
    dp, dcc = prune_inputs(rng, b, c)
    a2 = alpha * alpha
    got = tops.prune_scan(torch.from_numpy(dp), torch.from_numpy(dcc), a2,
                          r).numpy()
    from repro.kernels.prune_scan import prune_scan
    want_i = np.asarray(prune_scan(jnp.asarray(dp), jnp.asarray(dcc), a2, r,
                                   interpret=True))
    want_r = np.asarray(jref.prune_scan_ref(jnp.asarray(dp),
                                            jnp.asarray(dcc), a2, r))
    np.testing.assert_array_equal(got, want_r)
    np.testing.assert_array_equal(got, want_i)
    assert (got.sum(1) <= r).all()


@pytest.mark.parametrize("kind", PRUNE_KINDS)
@pytest.mark.parametrize("c", [1, 31, 32, 33, 129])
def test_prune_scan_edge_cases_match_repro(kind, c):
    """The cases the kernel's skip logic must get right (non-finite lanes
    amid finite ones, unsorted dp, exact ties a2·dcc == dp, r >= C, a row
    of +inf) against ``repro``'s kernel in interpret mode and its
    reference."""
    from repro.kernels.prune_scan import prune_scan
    rng = np.random.default_rng(c * 10 + PRUNE_KINDS.index(kind))
    dp, dcc, a2, r = prune_edge_inputs(rng, kind, 3, c)
    got = tops.prune_scan(torch.from_numpy(dp), torch.from_numpy(dcc), a2,
                          r).numpy()
    want_i = np.asarray(prune_scan(jnp.asarray(dp), jnp.asarray(dcc), a2, r,
                                   interpret=True))
    want_r = np.asarray(jref.prune_scan_ref(jnp.asarray(dp),
                                            jnp.asarray(dcc), a2, r))
    np.testing.assert_array_equal(got, want_r)
    np.testing.assert_array_equal(got, want_i)
    if kind == "all_inf":
        assert not got[0].any()


def test_prune_scan_respects_cap():
    rng = np.random.default_rng(7)
    dp, dcc = (torch.from_numpy(a) for a in prune_inputs(rng, 6, 40, 0.0))
    keep = tops.prune_scan(dp, torch.zeros_like(dcc), 1.0, 10)
    assert (keep.sum(1) == 1).all()
    keep = tops.prune_scan(dp, dcc, 1e9, 10)
    assert (keep.sum(1) == 10).all()


# ---------------------------------------------------------------------------
# pq_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 128, 700, 1024])
@pytest.mark.parametrize("m,k", [(8, 256), (16, 256), (32, 16)])
@pytest.mark.parametrize("codes_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("entry", ["slab", "gather"])
def test_pq_scan_matches_repro(n, m, k, codes_dtype, entry):
    """tests/test_kernels.py's grid: the plain version equals ``repro``'s
    jnp reference and its Pallas kernel in interpret mode bit for bit (all
    three add m left to right; no case of this grid needed that file's
    rtol=1e-6, atol=1e-5). The gathered entry takes n ids (0, the last row
    and repeats among them) into a store of 2n + 3 rows and is held
    against ``repro`` on the rows numpy gathers."""
    from repro.kernels.pq_scan import pq_scan
    rng = np.random.default_rng(n * m + k)
    table = rng.normal(0, 1, (m, k)).astype(np.float32)
    if entry == "slab":
        codes = rng.integers(0, k, (n, m)).astype(codes_dtype)
        got = tops.pq_scan(torch.from_numpy(codes), torch.from_numpy(table))
        rows = codes
    else:
        store = rng.integers(0, k, (2 * n + 3, m)).astype(codes_dtype)
        ids = rng.integers(0, store.shape[0], n).astype(np.int32)
        ids[0] = store.shape[0] - 1
        ids[-1] = 0
        got = tops.pq_scan_gather(torch.from_numpy(store),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(table))
        rows = store[ids]
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.numpy()
    want_r = np.asarray(jref.pq_scan_ref(jnp.asarray(rows),
                                         jnp.asarray(table)))
    want_i = np.asarray(pq_scan(jnp.asarray(rows), jnp.asarray(table),
                                interpret=True, tile_n=256))
    np.testing.assert_array_equal(got.view(np.int32), want_r.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), want_i.view(np.int32))


def test_pq_scan_gather_out_of_range_ids():
    """An id outside [0, N) gives +inf and reads nothing; every other entry
    equals the slab entry on its row."""
    rng = np.random.default_rng(12)
    n, m, k = 50, 16, 256
    store = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    table = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    ids = torch.tensor([-1, n, 0, n - 1, -2 ** 31, 2 ** 31 - 1, 7, n + 1],
                       dtype=torch.int32)
    got = tops.pq_scan_gather(store, ids, table)
    bad = (ids < 0) | (ids >= n)
    assert torch.isinf(got[bad]).all() and (got[bad] > 0).all()
    want = tops.pq_scan(store[ids[~bad].long()], table)
    assert torch.equal(got[~bad].view(torch.int32), want.view(torch.int32))
    empty = tops.pq_scan_gather(store[:0], ids[:3], table)
    assert torch.isinf(empty).all()
    assert tops.pq_scan_gather(store, ids[:0], table).shape == (0,)


def test_pq_scan_out_of_range_codes_match_repro():
    """Codes outside [0, K) read as XLA's gather reads them in ``repro``'s
    reference: a negative code wraps once, then it is clamped."""
    rng = np.random.default_rng(4)
    k = 16
    codes = rng.integers(-3 * k, 3 * k, (64, 8)).astype(np.int32)
    table = rng.normal(0, 1, (8, k)).astype(np.float32)
    got = tops.pq_scan(torch.from_numpy(codes), torch.from_numpy(table))
    want = np.asarray(jref.pq_scan_ref(jnp.asarray(codes),
                                       jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_pq_scan_equals_adc_lookup():
    """The pre route's ADC distances: ``pq.adc_lookup`` of gathered code
    rows equals ``pq_scan`` on them (same function, same bits), and
    ``repro``'s ``pq.adc_lookup`` too."""
    from repro.core import pq as jpq
    from repro_torch.core import pq as tpq
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 256, (300, 16)).astype(np.uint8)
    table = (rng.normal(0, 1, (16, 256)) ** 2).astype(np.float32)
    got = tops.pq_scan(torch.from_numpy(codes), torch.from_numpy(table))
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        tpq.adc_lookup(torch.from_numpy(codes),
                       torch.from_numpy(table)).numpy().view(np.int32))
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        np.asarray(jpq.adc_lookup(jnp.asarray(codes),
                                  jnp.asarray(table))).view(np.int32))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# approx_probe
# ---------------------------------------------------------------------------

def _probe_inputs(rng, n, bucket_dtype, ql=8):
    """tests/test_kernels.py's generator, with blooms over all 32 bits (so
    words >= 2**31 occur) and the bucket type given."""
    blooms = rng.integers(0, 2 ** 32, n, dtype=np.int64).astype(np.uint32)
    buckets = rng.integers(0, 256, n).astype(bucket_dtype)
    or_masks = rng.integers(0, 2 ** 16, ql).astype(np.uint32)
    params = np.array([int(rng.integers(0, 2 ** 16)), ql,
                       int(rng.integers(0, 128)), int(rng.integers(128, 256)),
                       int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                       int(rng.integers(0, 2)), 0], np.int32)
    return blooms, buckets, or_masks, params


def _probe_all(args):
    """(port plain, repro oracle, repro interpret-mode Pallas) on the same
    numpy inputs."""
    got = tops.approx_probe(*(torch.from_numpy(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    return (got, np.asarray(jref.approx_probe_ref(*jargs)),
            np.asarray(jops.approx_probe_interpret(*jargs)))


@pytest.mark.parametrize("n", [1, 64, 999, 2048])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bucket_dtype", [np.uint8, np.int32])
def test_approx_probe_matches_repro(n, seed, bucket_dtype):
    got, oracle, pallas = _probe_all(
        _probe_inputs(np.random.default_rng(seed), n, bucket_dtype))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("label_mode", [0, 1, 2])
@pytest.mark.parametrize("range_on", [0, 1])
@pytest.mark.parametrize("combine", [0, 1])
def test_approx_probe_mode_combos_match_repro(label_mode, range_on, combine):
    """All 12 mode combinations, with zero OR masks (never hit), a mask of
    bit 31, an int32 view of the same words, and params[1] = 0 (ignored:
    every mask is tested)."""
    rng = np.random.default_rng(7)
    n = 333
    blooms = rng.integers(0, 2 ** 32, n, dtype=np.int64).astype(np.uint32)
    buckets = rng.integers(0, 256, n).astype(np.uint8)
    or_masks = np.array([0, 0b11, 1 << 31, 0, 0x50, 0b1010, 0, 1],
                        np.uint32)
    params = np.array([0b1010, 0, 50, 200, label_mode, range_on, combine, 0],
                      np.int32)
    for bl, om in ((blooms, or_masks),
                   (blooms.view(np.int32), or_masks.view(np.int32))):
        got, oracle, pallas = _probe_all((bl, buckets, om, params))
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, pallas)


def test_approx_probe_zero_and_mask_admits_all():
    n = 100
    rng = np.random.default_rng(3)
    blooms = rng.integers(0, 2 ** 32, n, dtype=np.int64).astype(np.uint32)
    params = np.array([0, 0, 0, 255, 1, 0, 0, 0], np.int32)
    got, oracle, pallas = _probe_all(
        (blooms, np.zeros(n, np.uint8), np.zeros(8, np.uint32), params))
    assert got.all()
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


# ---------------------------------------------------------------------------
# l2_rerank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d", [(1, 8), (17, 64), (300, 128), (256, 48),
                                 (257, 192)])
def test_l2_rerank_matches_repro(b, d):
    """The plain version against the interpret-mode Pallas kernel (the same
    |v|^2 - 2 v.q + |q|^2 formula, another summation order) within
    rtol=atol=1e-5, and against the jnp oracle sum((v - q)^2) within
    tests/test_kernels.py's rtol=atol=1e-4."""
    rng = np.random.default_rng(b * d)
    vecs = rng.normal(0, 1, (b, d)).astype(np.float32)
    q = rng.normal(0, 1, d).astype(np.float32)
    got = tops.l2_rerank(torch.from_numpy(vecs), torch.from_numpy(q)).numpy()
    pallas = np.asarray(jops.l2_rerank_interpret(jnp.asarray(vecs),
                                                 jnp.asarray(q)))
    oracle = np.asarray(jref.l2_rerank_ref(jnp.asarray(vecs),
                                           jnp.asarray(q)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def test_l2_rerank_near_duplicates_not_clamped():
    """Rows equal to the query cancel to ~0 and may come out negative: the
    plain version does not clamp (the TPU kernel does not)."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 3, 192).astype(np.float32)
    vecs = np.stack([q] * 64).astype(np.float32)
    vecs[1::2] += np.float32(1e-4)
    got = tops.l2_rerank(torch.from_numpy(vecs), torch.from_numpy(q)).numpy()
    pallas = np.asarray(jops.l2_rerank_interpret(jnp.asarray(vecs),
                                                 jnp.asarray(q)))
    scale = float((q * q).sum()) * 2
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5 * scale)
    assert np.abs(got).max() < 1e-3 * scale


def test_cpu_dispatch_counts_no_launch():
    """CPU tensors take the plain versions and count no kernel launch."""
    tops.reset_launches()
    rng = np.random.default_rng(0)
    tops.hop_fused(*(torch.from_numpy(a) for a in hop_inputs(rng, 2, 9)))
    tops.hop_fused_gather(*(torch.from_numpy(a)
                            for a in gather_inputs(rng, 2, 9, 40)))
    tops.or_scatter(torch.zeros((1, 2), dtype=torch.int32),
                    torch.zeros((1, 3), dtype=torch.int32))
    tops.or_scatter_(torch.zeros((1, 2), dtype=torch.int32),
                     torch.zeros((1, 3), dtype=torch.int32), 5)
    tops.or_scatter_new(torch.zeros((1, 3), dtype=torch.int32), 2)
    dp, dcc = prune_inputs(rng, 2, 8)
    tops.prune_scan(torch.from_numpy(dp), torch.from_numpy(dcc), 1.0, 4)
    tops.pq_scan(torch.zeros((5, 4), dtype=torch.uint8),
                 torch.zeros((4, 16), dtype=torch.float32))
    tops.pq_scan_gather(torch.zeros((5, 4), dtype=torch.uint8),
                        torch.zeros(3, dtype=torch.int32),
                        torch.zeros((4, 16), dtype=torch.float32))
    tops.approx_probe(torch.zeros(5, dtype=torch.int32),
                      torch.zeros(5, dtype=torch.uint8),
                      torch.zeros(8, dtype=torch.int32),
                      torch.zeros(8, dtype=torch.int32))
    tops.l2_rerank(torch.zeros((3, 8)), torch.zeros(8))
    assert tops.LAUNCHES == {"hop_fused": 0, "or_scatter": 0,
                             "prune_scan": 0, "pq_scan": 0,
                             "approx_probe": 0, "l2_rerank": 0}


def test_launch_snapshot_restore():
    """``snapshot`` copies the counts and ``restore`` puts them back, so a
    caller can leave launches out of a run's counts."""
    tops.reset_launches()
    tops._count("pq_scan")
    saved = tops.snapshot()
    assert saved == {"hop_fused": 0, "or_scatter": 0, "prune_scan": 0,
                     "pq_scan": 1, "approx_probe": 0, "l2_rerank": 0}
    tops._count("pq_scan")
    tops._count("hop_fused")
    assert saved["pq_scan"] == 1            # a copy, not a view
    tops.restore(saved)
    assert tops.LAUNCHES == saved
    tops.reset_launches()
