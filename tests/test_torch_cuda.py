"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. Every case skips where there is no CUDA device; on the machine
with the card (which has no JAX) run

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py builds a ``repro`` engine and so
imports JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from torch_port_helpers import (PRUNE_KINDS, gather_inputs, gathered_slab,
                                hop_inputs, or_inputs, prune_edge_inputs,
                                prune_inputs)


@pytest.fixture
def cuda():
    """The card, decided at run time; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
    return torch.device("cuda")


def _same(got, want):
    """Two (key, ok) pairs, the first on the card: ok equal, key bits
    equal."""
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))


@pytest.mark.parametrize("b,c", [(1, 7), (3, 33), (64, 512)])
@pytest.mark.parametrize("m", [16, 8, 4, 32, 64, 48, 5])
def test_hop_fused_cuda_matches_plain(cuda, b, c, m):
    """The slab entry on the vector-load paths (M = 4, 8, 16, 32, 64) and
    the byte path (M = 48, 5); tables of 48 KB and more (M = 48, 64) need
    the kernel's opt-in to more shared memory."""
    rng = np.random.default_rng(b + c + m)
    args = [torch.from_numpy(a) for a in hop_inputs(rng, b, c, m=m)]
    _same(tops.hop_fused(*(a.to(cuda) for a in args)), tops.hop_fused(*args))


@pytest.mark.parametrize("b,c", [(1, 7), (3, 33), (64, 512), (2, 1100)])
@pytest.mark.parametrize("m", [16, 8, 5, 32, 48, 64])
@pytest.mark.parametrize("merged_mode", [1, 2])
def test_hop_fused_gather_cuda_matches_plain(cuda, b, c, m, merged_mode):
    """The gathered entry against its plain version and against the slab
    entry on the slab it gathers (C = 1100 loops over the block), on the
    vector-load paths (M = 8, 16, 32, 64) and the byte path (M = 5, 48)."""
    rng = np.random.default_rng(b * c + m)
    args = gather_inputs(rng, b, c, 5000, m=m, merged_mode=merged_mode)
    targs = [torch.from_numpy(a) for a in args]
    got = tops.hop_fused_gather(*(a.to(cuda) for a in targs))
    _same(got, tops.hop_fused_gather(*targs))
    _same(got, tops.hop_fused(*(torch.from_numpy(a)
                                for a in gathered_slab(args))))


def test_hop_fused_gather_cuda_out_of_range_ids(cuda):
    """An id outside [0, N) reads nothing and writes key +inf, ok False, as
    the plain version does; the other candidates are unchanged."""
    rng = np.random.default_rng(8)
    targs = [torch.from_numpy(a) for a in gather_inputs(rng, 4, 300, 777,
                                                        m=16)]
    ids = targs[4]
    ids[0, :5] = -1
    ids[1, 7] = 777
    ids[2, ::2] = 2 ** 31 - 1
    ids[3, 9] = -2 ** 31
    got = tops.hop_fused_gather(*(a.to(cuda) for a in targs))
    _same(got, tops.hop_fused_gather(*targs))
    bad = ((ids < 0) | (ids >= 777)).to(cuda)
    assert torch.isinf(got[0][bad]).all() and not got[1][bad].any()


def test_hop_fused_cuda_refuses_misaligned(cuda):
    """Vector loads need aligned rows and the bulk copy an aligned table:
    the wrappers refuse views that break either."""
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a).to(cuda) for a in hop_inputs(rng, 2, 8,
                                                             m=16)]
    flat = torch.zeros(2 * 8 * 16 + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="must start on 16 bytes"):
        tops.hop_fused(flat[1:].view(2, 8, 16), *args[1:])
    ftab = torch.zeros(args[4].numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="table must start on 16"):
        tops.hop_fused(*args[:4], ftab[1:].view(args[4].shape), *args[5:])
    gargs = [torch.from_numpy(a).to(cuda)
             for a in gather_inputs(rng, 2, 8, 100, m=8)]
    codes = torch.zeros(100 * 8 + 4, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="must start on 8 bytes"):
        tops.hop_fused_gather(codes[4:].view(100, 8), *gargs[1:])


def test_hop_fused_cuda_refuses_tables_past_the_opt_in_limit(cuda):
    """A table past the card's opt-in shared memory (less the 16 bytes
    before it) is refused before any launch, and M = 64 rows off 16 bytes
    are refused too."""
    rng = np.random.default_rng(6)
    tops.reset_launches()
    args = [torch.from_numpy(a).to(cuda)
            for a in hop_inputs(rng, 2, 8, m=64, k=1024)]
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tops.hop_fused(*args)
    gargs = [torch.from_numpy(a).to(cuda)
             for a in gather_inputs(rng, 2, 8, 100, m=64)]
    codes = torch.zeros(100 * 64 + 8, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="must start on 16 bytes"):
        tops.hop_fused_gather(codes[8:].view(100, 64), *gargs[1:])
    assert tops.LAUNCHES["hop_fused"] == 0
    tops.hop_fused_gather(*gargs)
    assert tops.LAUNCHES["hop_fused"] == 1


def test_hop_fused_cuda_out_of_range_field(cuda):
    """A range slot naming field F reads 0 in the kernel and the plain
    version alike."""
    rng = np.random.default_rng(3)
    args = list(hop_inputs(rng, 8, 256, m=16))
    args[7][:, 0] = args[2].shape[-1]
    args[8][::2] = 1
    args = [torch.from_numpy(a) for a in args]
    key_p, ok_p = tops.hop_fused(*args)
    key_k, ok_k = tops.hop_fused(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert torch.equal(ok_k.cpu(), ok_p)
    assert torch.equal(key_k.cpu().view(torch.int32), key_p.view(torch.int32))


@pytest.mark.parametrize("b,nw,c", [(3, 8, 33), (64, 32768, 32),
                                    (64, 188, 2048)])
def test_or_scatter_cuda_matches_plain(cuda, b, nw, c):
    words, slots = or_inputs(b, nw, c, 0)
    w, s = torch.from_numpy(words), torch.from_numpy(slots)
    got = tops.or_scatter(w.to(cuda), s.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tops.or_scatter(w, s))


# the main shapes (visited set at N = 1M, rare list at N = 1M), odd
# widths, and a row of the rare list at N = 10M
OR_SHAPES = [(64, 32768, 32), (64, 31251, 2048), (3, 8191, 33),
             (3, 8193, 33), (2, 312501, 2048)]


def _or_edge_slots(b, nw, c, seed):
    """or_inputs' slots with the table's first and last bits forced in."""
    _, slots = or_inputs(b, nw, c, seed)
    edges = [nw * 32 - 1, 0]
    k = min(c, len(edges))
    slots[:, :k] = np.array(edges[:k], np.int32)
    return torch.from_numpy(slots)


@pytest.mark.parametrize("n_ids", [None, 2 ** 20 + 1])
@pytest.mark.parametrize("b,nw,c", OR_SHAPES)
def test_or_scatter_inplace_cuda_matches_plain(cuda, b, nw, c, n_ids):
    """The in-place entry updates the card tensor it was given, as its plain
    version does on a CPU copy (slots as ids, or hashed visited slots)."""
    words, _ = or_inputs(b, nw, c, 1)
    w = torch.from_numpy(words)
    s = _or_edge_slots(b, nw, c, 1)
    dw = w.to(cuda)
    ptr = dw.data_ptr()
    got = tops.or_scatter_(dw, s.to(cuda), n_ids)
    torch.cuda.synchronize()
    assert got is dw and dw.data_ptr() == ptr
    assert torch.equal(dw.cpu(), tops.or_scatter_(w.clone(), s, n_ids))


@pytest.mark.parametrize("n_ids", [None, 2 ** 20 + 1])
@pytest.mark.parametrize("b,nw,c", OR_SHAPES + [(64, 32768, 1), (5, 7, 0),
                                                (3, 1, 5), (3, 300, 5000)])
def test_or_scatter_new_cuda_matches_plain(cuda, b, nw, c, n_ids):
    """The fresh-table entry equals its plain version."""
    s = _or_edge_slots(b, nw, c, 2)
    got = tops.or_scatter_new(s.to(cuda), nw, n_ids)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tops.or_scatter_new(s, nw, n_ids))


def test_or_scatter_entries_count_and_refuse(cuda):
    """Each launch of either new entry counts once under ``or_scatter``
    (none for a call with no id); ids of the wrong type or layout are
    refused before any launch."""
    tops.reset_launches()
    words = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    tops.or_scatter_(words, ids[:, :0])
    tops.or_scatter_new(ids[:, :0], 5)
    assert tops.LAUNCHES["or_scatter"] == 0
    tops.or_scatter_(words, ids)
    tops.or_scatter_new(ids, 5)
    assert tops.LAUNCHES["or_scatter"] == 2
    with pytest.raises(TypeError):
        tops.or_scatter_(words.long(), ids)
    with pytest.raises(TypeError):
        tops.or_scatter_new(ids.long(), 5)
    with pytest.raises(ValueError, match="not contiguous"):
        tops.or_scatter_(words, torch.zeros((3, 2), dtype=torch.int32,
                                            device=cuda).t())
    torch.cuda.synchronize()
    assert tops.LAUNCHES["or_scatter"] == 2


PRUNE_C = [1, 33, 40, 74, 96, 128, 200, 1024]


@pytest.mark.parametrize("c", PRUNE_C)
@pytest.mark.parametrize("r", [1, 8, 32, "C"])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_prune_scan_cuda_matches_plain(cuda, c, r, alpha):
    rng = np.random.default_rng(c)
    r = c if r == "C" else r
    rows = 256 if c <= 128 else 8
    dp, dcc = (torch.from_numpy(a) for a in prune_inputs(rng, rows, c))
    got = tops.prune_scan(dp.to(cuda), dcc.to(cuda), alpha * alpha, r)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tops.prune_scan(dp, dcc, alpha * alpha, r))


@pytest.mark.parametrize("c", PRUNE_C)
@pytest.mark.parametrize("kind", PRUNE_KINDS + ("noprune",))
def test_prune_scan_cuda_edge_cases(cuda, c, kind):
    """Non-finite lanes amid finite ones, unsorted dp, exact ties, r >= C,
    an all-+inf row, and rows where nothing prunes (every row keeps r)."""
    rng = np.random.default_rng(c + 7)
    if kind == "noprune":
        dp, dcc = prune_inputs(rng, 8, c, pad_frac=0.0)
        dcc = dcc + np.float32(1e3)
        a2, r = 1.44, 32
    else:
        dp, dcc, a2, r = prune_edge_inputs(rng, kind, 8, c)
    dp, dcc = torch.from_numpy(dp), torch.from_numpy(dcc)
    got = tops.prune_scan(dp.to(cuda), dcc.to(cuda), a2, r)
    torch.cuda.synchronize()
    want = tops.prune_scan(dp, dcc, a2, r)
    assert torch.equal(got.cpu(), want)
    if kind == "noprune":
        assert (want.sum(1) == min(r, c)).all()


def _rows(n, cuda):
    """A row count of the pq_scan grid: an int, or one row either side of
    one full wave of the kernel's grid (SMs x 8 blocks x 256 threads), past
    which a thread takes a second row."""
    if isinstance(n, int):
        return n
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    wave = sms * 8 * 256
    return wave - 1 if n == "wave-1" else wave + 1


def _pq_codes(rng, n, m, k, dtype):
    """Codes of the grid: uint8 over all 256 values (past K when K = 16, so
    the clamp is read), int32 in [0, K)."""
    hi = 256 if dtype == np.uint8 else k
    return torch.from_numpy(rng.integers(0, hi, (n, m)).astype(dtype))


def _misaligned(t, cuda):
    """A copy of ``t`` on the card whose storage starts one element past a
    16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
    flat[1:] = t.reshape(-1).to(cuda)
    view = flat[1:].view(t.shape)
    assert view.data_ptr() % 16
    return view


def _bits_equal(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [1, 31, 33, "wave-1", "wave+1", 1_000_000])
@pytest.mark.parametrize("m", [4, 8, 16, 32, 64, 5])
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_pq_scan_cuda_matches_plain(cuda, n, m, k, dtype):
    """Bit-identical to the plain version at M = 4, 8, 16, 32, 64 and 5 (a
    64 KB table at M = 64, K = 256, over the default 48 KB), on
    aligned rows (16-byte loads where a row is a whole number of them) and
    on a view one element off 16 bytes (a code at a time), below and past
    one wave of the grid, and on codes out of range."""
    n = _rows(n, cuda)
    rng = np.random.default_rng(n + m + k)
    codes = _pq_codes(rng, n, m, k, dtype)
    table = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    want = tops.pq_scan(codes, table)
    _bits_equal(tops.pq_scan(codes.to(cuda), table.to(cuda)), want)
    _bits_equal(tops.pq_scan(_misaligned(codes, cuda), table.to(cuda)), want)
    if dtype == np.int32:
        bad = torch.from_numpy(rng.integers(-2 * k, 2 * k, (n, m))
                               .astype(np.int32))
        _bits_equal(tops.pq_scan(bad.to(cuda), table.to(cuda)),
                    tops.pq_scan(bad, table))


@pytest.mark.parametrize("c", [1, 33, 50_000, "wave+1", 1_000_000])
@pytest.mark.parametrize("m", [16, 8, 32, 64, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_pq_scan_gather_cuda_matches_plain(cuda, c, m, dtype):
    """The gathered entry against its plain version and against the slab
    entry on the rows it gathers, with ids out of range (-1, N, +-2**31)
    among them, which give +inf; below and past one wave of the grid."""
    c = _rows(c, cuda)
    rng = np.random.default_rng(c + m)
    n, k = 100_000, 256
    store = _pq_codes(rng, n, m, k, dtype)
    table = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, n, c).astype(np.int32))
    ids[::7] = torch.tensor([-1, n, -2 ** 31, 2 ** 31 - 1],
                            dtype=torch.int32).repeat(c)[:ids[::7].numel()]
    want = tops.pq_scan_gather(store, ids, table)
    got = tops.pq_scan_gather(store.to(cuda), ids.to(cuda), table.to(cuda))
    _bits_equal(got, want)
    _bits_equal(tops.pq_scan_gather(_misaligned(store, cuda), ids.to(cuda),
                                    table.to(cuda)), want)
    bad = (ids < 0) | (ids >= n)
    assert torch.isinf(want[bad]).all()
    _bits_equal(got[~bad.to(cuda)],
                tops.pq_scan(store[ids[~bad].long()], table))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 999, 100_000, 1_000_000,
                               2_000_003])
@pytest.mark.parametrize("bucket_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("misaligned", [False, True])
def test_approx_probe_cuda_matches_plain(cuda, n, bucket_dtype, misaligned):
    """Equal to the plain version on every mode combination, with uint32
    blooms >= 2**31 and both bucket types, at 4 and 8 rows a thread
    (N = 100,000; 1M and 2M), the ragged tail, and views one element off
    16 bytes (``blooms[1:]``)."""
    rng = np.random.default_rng(n)
    blooms = torch.from_numpy(rng.integers(0, 2 ** 32, n + 1, dtype=np.int64)
                              .astype(np.uint32))
    buckets = torch.from_numpy(rng.integers(0, 256, n + 1)
                               .astype(bucket_dtype))
    if misaligned:
        blooms, buckets = blooms[1:], buckets[1:]
        gb, gk = blooms.to(cuda), buckets.to(cuda)
        gb, gk = _misaligned(gb.view(torch.int32), cuda), \
            _misaligned(gk, cuda)
    else:
        blooms, buckets = blooms[:n], buckets[:n]
        gb, gk = blooms.to(cuda), buckets.to(cuda)
    or_masks = torch.from_numpy(np.array(
        [0, 5, 1 << 31, 0x30, 0, 7, 0x100, 3], np.uint32))
    for label_mode in (0, 1, 2):
        for range_on in (0, 1):
            for combine in (0, 1):
                params = torch.tensor([0b1010, 8, 50, 200, label_mode,
                                       range_on, combine, 0],
                                      dtype=torch.int32)
                want = tops.approx_probe(blooms, buckets, or_masks, params)
                got = tops.approx_probe(gb, gk, or_masks.to(cuda),
                                        params.to(cuda))
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want), (label_mode, range_on,
                                                      combine)


@pytest.mark.parametrize("b,d", [(1, 8), (17, 64), (257, 192), (300, 130),
                                 (4096, 128)])
def test_l2_rerank_cuda_matches_plain(cuda, b, d):
    """Within float32 rounding of the plain version, on the float4 path
    (D % 4 == 0) and the scalar path (D = 130)."""
    rng = np.random.default_rng(b * d)
    vecs = torch.from_numpy(rng.normal(0, 1, (b, d)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, d).astype(np.float32))
    want = tops.l2_rerank(vecs, q)
    got = tops.l2_rerank(vecs.to(cuda), q.to(cuda))
    torch.cuda.synchronize()
    scale = float(((vecs * vecs).sum(1) + (q * q).sum()).max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5 * scale)


def test_cuda_wrappers_count_and_check(cuda):
    tops.reset_launches()
    words = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    tops.or_scatter(words, torch.zeros((2, 3), dtype=torch.int32,
                                       device=cuda))
    assert tops.LAUNCHES["or_scatter"] == 1
    tops.pq_scan(torch.zeros((3, 16), dtype=torch.uint8, device=cuda),
                 torch.zeros((16, 256), dtype=torch.float32, device=cuda))
    assert tops.LAUNCHES["pq_scan"] == 1
    tops.pq_scan_gather(torch.zeros((3, 16), dtype=torch.uint8,
                                    device=cuda),
                        torch.zeros(5, dtype=torch.int32, device=cuda),
                        torch.zeros((16, 256), dtype=torch.float32,
                                    device=cuda))
    assert tops.LAUNCHES["pq_scan"] == 2
    # a 64 KB table stages past the default 48 KB; one past the card's
    # opt-in limit is refused before any launch
    tops.pq_scan(torch.zeros((3, 64), dtype=torch.uint8, device=cuda),
                 torch.zeros((64, 256), dtype=torch.float32, device=cuda))
    assert tops.LAUNCHES["pq_scan"] == 3
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tops.pq_scan(torch.zeros((3, 64), dtype=torch.uint8, device=cuda),
                     torch.zeros((64, 1024), dtype=torch.float32,
                                 device=cuda))
    assert tops.LAUNCHES["pq_scan"] == 3
    with pytest.raises(TypeError):
        tops.or_scatter(words.long(), torch.zeros((2, 3), dtype=torch.int32,
                                                  device=cuda))
    tops.approx_probe(torch.zeros(5, dtype=torch.int32, device=cuda),
                      torch.zeros(5, dtype=torch.uint8, device=cuda),
                      torch.zeros(8, dtype=torch.int32, device=cuda),
                      torch.zeros(8, dtype=torch.int32, device=cuda))
    assert tops.LAUNCHES["approx_probe"] == 1
    tops.l2_rerank(torch.zeros((3, 8), device=cuda),
                   torch.zeros(8, device=cuda))
    assert tops.LAUNCHES["l2_rerank"] == 1
    gargs = gather_inputs(np.random.default_rng(0), 2, 9, 40)
    tops.hop_fused_gather(*(torch.from_numpy(a).to(cuda) for a in gargs))
    assert tops.LAUNCHES["hop_fused"] == 1
    with pytest.raises(ValueError, match="exceed 8"):
        tops.approx_probe(torch.zeros(5, dtype=torch.int32, device=cuda),
                          torch.zeros(5, dtype=torch.uint8, device=cuda),
                          torch.zeros(9, dtype=torch.int32, device=cuda),
                          torch.zeros(8, dtype=torch.int32, device=cuda))


def test_disk_backend_equals_device_backend_on_card(cuda, tmp_path):
    """The disk tier on the card (tests/test_torch_storage.py's corpus and
    config): ``Index.build(store="disk")``'s answers equal those of the same
    index on the device backend under every policy (the pre route and the
    scan rung included), clean and under a fault plan, and its hop loop
    launches the same kernels through the same entries. Each run, on
    either backend, is made once before it is counted, so that its hop
    graphs are captured (a capture's warm-up hop launches kernels of its
    own)."""
    import copy
    import dataclasses
    from repro_torch import api as tapi
    from repro_torch.core.faults import FaultPlan

    rng = np.random.default_rng(7)
    vectors = rng.normal(0, 1, (600, 24)).astype(np.float32)
    metadata = [{"cat": sorted(set(int(x) for x in
                               rng.integers(0, 8, rng.integers(1, 4)))),
                 "value": float(v)}
                for v in rng.uniform(0, 100, 600)]
    cfg = tapi.IndexConfig(r=12, r_dense=60, l_build=24, pq_m=8)
    defaults = tapi.SearchConfig(k=5, l=16, max_hops=60)
    idx = tapi.Index.build(vectors, metadata, cfg, defaults=defaults,
                           device=cuda)
    dsk = copy.copy(idx)
    dsk.engine = copy.copy(idx.engine)
    dsk.engine.to_disk(str(tmp_path / "slabs"))
    assert dsk.engine.store.vectors.device.type == cuda.type
    tag, num = tapi.Tag("cat"), tapi.Num("value")
    reqs = [tapi.SearchRequest(query=vectors[i] + 0.01,
                               filter=(tag == 2, num < 50.0,
                                       (tag == 2) | (num < 60.0))[i % 3],
                               policy=pol)
            for i in range(6)
            for pol in ("strict_in", "post", "speculative", "strict_pre")]
    plan = FaultPlan(read_fail_rate=0.08, corrupt_rate=0.04, seed=11)
    for scfgs in (None, [dataclasses.replace(defaults, policy=r.policy,
                                             fault_plan=plan)
                         for r in reqs]):
        for run in ("search_batch", "approx_scan_batch"):
            getattr(idx, run)(reqs, with_metadata=False, scfgs=scfgs)
            tops.reset_launches()
            want, sw = getattr(idx, run)(reqs, with_stats=True,
                                         with_metadata=False, scfgs=scfgs)
            device_launches = tops.snapshot()
            getattr(dsk, run)(reqs, with_metadata=False, scfgs=scfgs)
            tops.reset_launches()
            got, sg = getattr(dsk, run)(reqs, with_stats=True,
                                        with_metadata=False, scfgs=scfgs)
            assert tops.snapshot() == device_launches, run
            assert sg.mechanism == sw.mechanism
            for f in ("io_pages", "hops", "dist_comps", "n_valid",
                      "explored", "fp_explored", "faults", "retries",
                      "degraded"):
                np.testing.assert_array_equal(getattr(sg, f),
                                              getattr(sw, f), err_msg=f)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(a.ids, b.ids)
                np.testing.assert_array_equal(a.dists, b.dists)
            assert sg.disk["records_fetched"] > 0
            if run == "search_batch":
                assert {"pre", "in", "post"} <= set(sg.mechanism)


@pytest.fixture
def card_and_cpu_engines(cuda):
    """An engine built on the card over a 600-record corpus and its copy on
    the CPU (``from_arrays``), with a range batch of 12 queries at 30%
    selectivity in the port's filter form."""
    from repro_torch.core import engine as teng
    from repro_torch.core.selectors import stack_filters
    from repro_torch.data.synth import (make_filtered_dataset,
                                        make_sliding_range_selectors)
    ds = make_filtered_dataset(n=600, d=24, n_queries=12, n_labels=12,
                               seed=0)
    cfg = teng.IndexConfig(r=12, r_dense=48, l_build=24, pq_m=8)
    gpu = teng.FilteredANNEngine.build(ds.vectors, ds.label_offsets,
                                       ds.label_flat, ds.n_labels, ds.values,
                                       cfg, device=cuda)
    cpu = teng.FilteredANNEngine.from_arrays(gpu.arrays(), cfg,
                                             device="cpu")
    sels = make_sliding_range_selectors(gpu, 0.30, 12)
    qf = stack_filters([s.plan(cfg.ql, cfg.cap).qfilter for s in sels])
    ents = np.full((12, 4), -1, np.int32)
    for j, s in enumerate(sels):
        seeds, _ = teng._strict_seed_ids(s, gpu.medoid, 4)
        ents[j, :seeds.size] = seeds
    return gpu, cpu, ds, qf, ents


def _search_args(e, ds, qf, mode):
    from repro_torch.core import search as tsearch
    p = tsearch.SearchParams(l_search=24, k=5, max_hops=80, beam_width=2,
                             mode=mode, l_valid=16)
    return (e.store, e.codes, e.codebook, e.mem, qf, ds.queries, e.medoid,
            p)


def _fields_equal(got, want, tag):
    for f in got._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{tag}: {f}"


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_oracle_on_card_equals_cpu(card_and_cpu_engines, mode):
    """``filtered_search_ref`` on the card equals it on the CPU copy on
    every field, bit for bit, and the card's fused search meets the
    oracle's bar there (io_pages, explored, hops and n_valid equal)."""
    from repro_torch.core import search as tsearch
    gpu, cpu, ds, qf, ents = card_and_cpu_engines
    e_arg = ents if mode == "strict_in" else None
    on_card = tsearch.filtered_search_ref(*_search_args(gpu, ds, qf, mode),
                                          entries=e_arg)
    on_cpu = tsearch.filtered_search_ref(*_search_args(cpu, ds, qf, mode),
                                         entries=e_arg)
    _fields_equal(on_card, on_cpu, f"oracle {mode}")
    fused = tsearch.filtered_search(*_search_args(gpu, ds, qf, mode),
                                    entries=e_arg)
    for f in ("io_pages", "explored", "hops", "n_valid"):
        assert torch.equal(getattr(fused, f), getattr(on_card, f)), f


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_pq_scan_distance_fn_on_card_equals_default(card_and_cpu_engines,
                                                    mode):
    """``distance_fn=ops.pq_scan`` on the card: the compacting driver's
    result equals the default path's on every field, bit for bit, with
    ``pq_scan`` launched (and, in spec_in, no ``hop_fused``)."""
    from repro_torch.core import search as tsearch
    gpu, _, ds, qf, ents = card_and_cpu_engines
    e_arg = ents if mode == "strict_in" else None
    args = _search_args(gpu, ds, qf, mode)
    tops.reset_launches()
    default = tsearch.filtered_search_pipelined(*args, entries=e_arg)
    want_launches = tops.snapshot()
    tops.reset_launches()
    scanned = tsearch.filtered_search_pipelined(*args, entries=e_arg,
                                                distance_fn=tops.pq_scan)
    got_launches = tops.snapshot()
    _fields_equal(scanned, default, f"pq_scan distance {mode}")
    assert want_launches["pq_scan"] == 0 and got_launches["pq_scan"] > 0
    assert got_launches["hop_fused"] == 0
    assert (want_launches["hop_fused"] > 0) == (mode == "spec_in")


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_sharded_runner_on_card_equals_unsharded(card_and_cpu_engines, mode,
                                                 shards):
    """``ShardedSearchRunner`` over ``local_plan(S, cuda)``: the pipelined
    driver's result equals the unsharded card run on every field, bit for
    bit, and the same sharded run on the CPU copy; on the card the shards'
    hop steps launch ``or_scatter`` (and in spec_in ``hop_fused``)."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core import search as tsearch
    gpu, cpu, ds, qf, ents = card_and_cpu_engines
    e_arg = ents if mode == "strict_in" else None
    args = _search_args(gpu, ds, qf, mode)
    want = tsearch.filtered_search_pipelined(*args, entries=e_arg)
    runner = tdist.ShardedSearchRunner(
        tdist.local_plan(shards, gpu.device), gpu.store, gpu.codes,
        gpu.codebook, gpu.mem)
    tops.reset_launches()
    got = tsearch.filtered_search_pipelined(*args, entries=e_arg,
                                            runner=runner)
    launches = tops.snapshot()
    _fields_equal(got, want, f"sharded S={shards} {mode}")
    cpu_runner = tdist.ShardedSearchRunner(
        tdist.local_plan(shards, "cpu"), cpu.store, cpu.codes, cpu.codebook,
        cpu.mem)
    on_cpu = tsearch.filtered_search_pipelined(
        *_search_args(cpu, ds, qf, mode), entries=e_arg, runner=cpu_runner)
    _fields_equal(got, on_cpu, f"sharded S={shards} {mode} card vs CPU")
    assert launches["or_scatter"] > 0
    assert (launches["hop_fused"] > 0) == (mode == "spec_in")


def _tiled(qf, queries, b):
    """The batch's filters and queries repeated to ``b`` rows."""
    idx = np.arange(b) % queries.shape[0]
    return type(qf)(*(np.asarray(x)[idx] for x in qf)), queries[idx]


def _states_equal(got, want, tag):
    for f, a, b in zip(got._fields, got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{tag}: {f}"


@pytest.mark.parametrize("mode", ["post", "spec_in"])
def test_hop_graph_equals_eager_loop_on_card(card_and_cpu_engines, mode,
                                            monkeypatch):
    """``run_hops`` on the card replays a captured hop. Over a chunk at
    width 64 (the capture), a second chunk there (replays only), and, after
    a compaction to width 8, a chunk there (a second capture), every
    ``HopState`` field, the visited words included, equals
    ``_run_hops_eager``'s bit for bit; the replayed chunk's kernel launches
    equal the eager chunk's, and the tally counts one capture a width. In
    the replayed chunk every hand-written kernel the profiler sees on the
    card was launched by a call of its ``ops`` entry: one kernel a call,
    as many as ``ops.LAUNCHES`` counts."""
    from repro_torch.core import search as tsearch
    from repro_torch.utils import trace
    gpu, _, ds, qf, _ = card_and_cpu_engines
    qf64, q64 = _tiled(qf, ds.queries, 64)
    p = tsearch.SearchParams(l_search=24, k=5, max_hops=80, beam_width=2,
                             mode=mode, l_valid=16)
    ctx, st = tsearch.init_search(gpu.store, gpu.codes, gpu.codebook,
                                  gpu.mem, qf64, q64, gpu.medoid, p)

    def chunk(run, c, s):
        tops.reset_launches()
        with trace.batch() as t:
            out = run(gpu.store, gpu.codes, gpu.mem, c, s, 6, p)
        torch.cuda.synchronize()
        return out, tops.snapshot(), t["graph_captures"]

    def clone(s):
        return tsearch.HopState(*(t.clone() for t in s))

    want, _, _ = chunk(tsearch._run_hops_eager, ctx, clone(st))
    got, _, caps = chunk(tsearch.run_hops, ctx, clone(st))
    assert caps == 1
    _states_equal(got, want, f"{mode} width 64, first chunk")
    assert bool(want.active.any())
    want, eager_launches, _ = chunk(tsearch._run_hops_eager, ctx, want)
    entry_calls = {"hop_fused_gather": 0, "or_scatter_": 0}
    for name in entry_calls:
        def counted(*a, _fn=getattr(tops, name), _name=name):
            entry_calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tops, name, counted)
    cuda_acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda_acts) as prof:
        got, graph_launches, caps = chunk(tsearch.run_hops, ctx, got)
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert caps == 0
    assert graph_launches == eager_launches
    assert entry_calls == {"hop_fused_gather": graph_launches["hop_fused"],
                           "or_scatter_": graph_launches["or_scatter"]}
    assert sum("hop_fused_kernel" in k for k in kernels) \
        == graph_launches["hop_fused"]
    assert sum("or_scatter_kernel" in k for k in kernels) \
        == graph_launches["or_scatter"]
    assert eager_launches["or_scatter"] == 6
    assert eager_launches["hop_fused"] == (6 if mode == "spec_in" else 0)
    _states_equal(got, want, f"{mode} width 64, replayed chunk")
    rows = torch.arange(0, 64, 8, device=gpu.device)
    ctx8 = tsearch.take_rows(ctx, rows)
    want, _, _ = chunk(tsearch._run_hops_eager, ctx8,
                       tsearch.take_rows(want, rows))
    got, _, caps = chunk(tsearch.run_hops, ctx8,
                         tsearch.take_rows(got, rows))
    assert caps == 1
    _states_equal(got, want, f"{mode} width 8 after compaction")


@pytest.mark.parametrize("mode", ["post", "spec_in"])
def test_disk_hop_graph_equals_eager_loop_on_card(card_and_cpu_engines, mode,
                                                 monkeypatch, tmp_path):
    """``run_hops`` over the disk tier's stand-in store on the card replays
    a captured hop with the disk fetch called between its graphs. Over a
    chunk at width 64 (the capture) and a second chunk there (replays
    only), every ``HopState`` field equals ``_run_hops_eager``'s with the
    same fetch callable, and the device backend's eager loop's, bit for
    bit. The capture's chunk reads the slabs once for its warm-up hop and
    once a replayed hop; the replayed chunk reads them once a hop (the
    eager loop once more), launches what the eager chunk launches, each
    hand-written kernel through a call of its ``ops`` entry, and the tally
    counts its every hop step as graphed."""
    from repro_torch.core import search as tsearch
    from repro_torch.storage import DiskRecordStore
    from repro_torch.utils import trace
    gpu, _, ds, qf, _ = card_and_cpu_engines
    disk = DiskRecordStore.from_record_store(str(tmp_path / "slabs"),
                                             gpu.store, n=gpu.n)
    stub, fetch = disk.stub_store(gpu.device), disk.fetch_callable
    qf64, q64 = _tiled(qf, ds.queries, 64)
    p = tsearch.SearchParams(l_search=24, k=5, max_hops=80, beam_width=2,
                             mode=mode, l_valid=16)
    ctx, st = tsearch.init_search(stub, gpu.codes, gpu.codebook, gpu.mem,
                                  qf64, q64, gpu.medoid, p)
    fetches = []
    read = disk.fetch
    monkeypatch.setattr(disk, "fetch", lambda *a, **kw: (
        fetches.append(1) or read(*a, **kw)))

    def chunk(run, s, store=stub, fetch_fn=fetch):
        tops.reset_launches()
        del fetches[:]
        with trace.batch() as t:
            out = run(store, gpu.codes, gpu.mem, ctx, s, 6, p, fetch_fn)
        torch.cuda.synchronize()
        return out, tops.snapshot(), t, len(fetches)

    def clone(s):
        return tsearch.HopState(*(t.clone() for t in s))

    local, _, _, _ = chunk(tsearch._run_hops_eager, clone(st), gpu.store,
                           tsearch.local_fetch)
    want, _, _, reads = chunk(tsearch._run_hops_eager, clone(st))
    assert reads == 7
    got, _, t, reads = chunk(tsearch.run_hops, clone(st))
    assert (t["graph_captures"], t["hop_steps_graphed"], reads) == (1, 6, 7)
    _states_equal(got, want, f"disk {mode}, first chunk")
    _states_equal(got, local, f"disk {mode} vs device, first chunk")
    assert bool(want.active.any())
    local, _, _, _ = chunk(tsearch._run_hops_eager, local, gpu.store,
                           tsearch.local_fetch)
    want, eager_launches, _, reads = chunk(tsearch._run_hops_eager, want)
    assert reads == 7
    entry_calls = {"hop_fused_gather": 0, "or_scatter_": 0}
    for name in entry_calls:
        def counted(*a, _fn=getattr(tops, name), _name=name):
            entry_calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tops, name, counted)
    got, graph_launches, t, reads = chunk(tsearch.run_hops, got)
    assert (t["graph_captures"], t["hop_steps_graphed"], reads) == (0, 6, 6)
    assert graph_launches == eager_launches
    assert entry_calls == {"hop_fused_gather": graph_launches["hop_fused"],
                           "or_scatter_": graph_launches["or_scatter"]}
    assert eager_launches["or_scatter"] == 6
    assert eager_launches["hop_fused"] == (6 if mode == "spec_in" else 0)
    _states_equal(got, want, f"disk {mode}, replayed chunk")
    _states_equal(got, local, f"disk {mode} vs device, replayed chunk")
    disk.close()


@pytest.mark.parametrize("mode", ["post", "spec_in", "strict_in"])
def test_pipelined_on_card_equals_single_shot(card_and_cpu_engines, mode):
    """``filtered_search_pipelined`` on the card, whose chunks replay hop
    graphs, equals ``filtered_search`` (no graph) on every field bit for
    bit, and its tally counts every hop step as graphed."""
    from repro_torch.core import search as tsearch
    from repro_torch.utils import trace
    gpu, _, ds, qf, ents = card_and_cpu_engines
    e_arg = ents if mode == "strict_in" else None
    args = _search_args(gpu, ds, qf, mode)
    want = tsearch.filtered_search(*args, entries=e_arg)
    with trace.batch() as t:
        got = tsearch.filtered_search_pipelined(*args, entries=e_arg,
                                                hop_chunk=8)
    _fields_equal(got, want, f"pipelined vs single-shot {mode}")
    assert t["hop_steps_graphed"] == t["hop_steps"] > 0
    assert t["graph_captures"] >= 1


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x22b"])
def test_lm_forward_and_decode_card_matches_cpu(cuda, arch):
    """The LM's smoke config on the card and on the CPU with the same
    weights: forward logits and aux losses, then a prefill of 16 tokens
    and 8 decode steps (mixtral: 40 and 8, past its window of 32), each
    step's logits within 1e-4 of the CPU's (float32, TF32 off)."""
    import copy
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = smoke_config(arch)
    cpu = lm.init_lm(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    s, prefix = (48, 40) if arch == "mixtral-8x22b" else (24, 16)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, s)))

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    want, waux = lm.lm_forward(cpu, cfg, {"tokens": tokens})
    got, gaux = lm.lm_forward(card, cfg, {"tokens": tokens.to(cuda)})
    close(got, want)
    for k in waux:
        close(gaux[k], waux[k])
    wl, wc = lm.lm_prefill(cpu, cfg, {"tokens": tokens[:, :prefix]}, s + 8)
    gl, gc = lm.lm_prefill(card, cfg, {"tokens": tokens[:, :prefix].to(cuda)},
                           s + 8)
    close(gl, wl)
    for i in range(prefix, s):
        wl, wc = lm.lm_decode_step(cpu, wc, cfg, tokens[:, i:i + 1])
        gl, gc = lm.lm_decode_step(card, gc, cfg,
                                   tokens[:, i:i + 1].to(cuda))
        close(gl, wl)


@pytest.mark.parametrize("arch,microbatches", [("jamba-v0.1-52b", 1),
                                               ("mixtral-8x22b", 2)])
def test_train_step_card_matches_cpu(cuda, arch, microbatches):
    """The training path's smoke config on the card and on the CPU from the
    same weights: loss and every gradient leaf, then the parameters after
    one train step at ``launch.train``'s optimizer settings (float32,
    TF32 off; within 1e-4)."""
    import copy
    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import lm
    from repro_torch.train import optim, train_loop
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = smoke_config(arch)
    cpu = lm.init_lm(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = lm_batch(cfg, 4, 32, 1)

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    wl, _, wg = train_loop.loss_and_grads(cpu, cfg, batch, microbatches)
    gl, _, gg = train_loop.loss_and_grads(card, cfg, batch, microbatches)
    close(gl, wl)
    for k in wg:
        close(gg[k], wg[k])
    ocfg = optim.OptConfig(lr=1e-3, warmup_steps=10)
    for model in (cpu, card):
        step = train_loop.make_train_step(cfg, ocfg, microbatches)
        step(model, optim.init_opt_state(model, ocfg), batch)
    for (_, p), (_, q) in zip(cpu.named_parameters(), card.named_parameters()):
        close(q.detach(), p.detach())


def test_threefry_and_int8_quantizers_card_equal_cpu(cuda):
    """Threefry draws, ``q8_quantize`` and ``compressed_psum_grads`` on the
    card equal the CPU's bit for bit (divisions by tensors, the float64
    fused multiply-adds)."""
    from repro_torch import random as R
    from repro_torch.train import grad_compress, optim
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 3, (5, 4099))
                              .astype(np.float32))
    for seed in (0, 42, -1):
        kc, kd = R.PRNGKey(seed), R.PRNGKey(seed, device=cuda)
        assert torch.equal(R.split(kd, 7).cpu(), R.split(kc, 7))
        assert torch.equal(R.random_bits(kd, (3, 513)).cpu(),
                           R.random_bits(kc, (3, 513)))
        assert torch.equal(R.uniform(kd, (3, 513), -2.5, 3.7).cpu(),
                           R.uniform(kc, (3, 513), -2.5, 3.7))
        assert torch.equal(R.gumbel(kd, (5, 4099)).cpu(),
                           R.gumbel(kc, (5, 4099)))
        assert torch.equal(R.categorical(kd, logits.to(cuda)).cpu(),
                           R.categorical(kc, logits))
    x = torch.from_numpy(rng.normal(0, 2, (7, 3, 300)).astype(np.float32))
    want, got = optim.q8_quantize(x), optim.q8_quantize(x.to(cuda))
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu(), want.scale)
    grads = [{"a": torch.from_numpy(rng.normal(0, s, (9, 301))
                                    .astype(np.float32))}
             for s in (1.0, 0.1, 3.0, 0.5)]
    errs = [grad_compress.init_error_feedback(g) for g in grads]
    mean, new = grad_compress.compressed_psum_grads(grads, errs)
    dmean, dnew = grad_compress.compressed_psum_grads(
        [{"a": g["a"].to(cuda)} for g in grads],
        [{"a": e["a"].to(cuda)} for e in errs])
    assert torch.equal(dmean["a"].cpu(), mean["a"])
    for d, w in zip(dnew, new):
        assert torch.equal(d["a"].cpu(), w["a"])


def test_sp_decode_card_matches_cpu(cuda):
    """qwen2-1.5b's smoke config with ``sp_decode`` under a local (1, 4)
    mesh on the card: greedy tokens equal the CPU's plain decode and each
    step's logits within 1e-4 (float32, TF32 off); split-K attention on
    card tensors against the CPU's within 2e-5, and the owner-only cache
    update on the card equal to the CPU's."""
    import copy
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import (clear_activation_sharding,
                                           set_activation_sharding)
    from repro_torch.serve import generate
    from repro_torch.serve import sp_attention as SP
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = smoke_config("qwen2-1.5b")
    cpu = lm.init_lm(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 20))
    want = generate(cpu, cfg, prompts, 10, max_t=40)
    sp_cfg = dataclasses.replace(cfg, sp_decode=True)
    try:
        set_activation_sharding(make_local_mesh(1, 4, cuda), ("data",))
        got = generate(card, sp_cfg, prompts, 10, max_t=40)
        _, caches = lm.lm_prefill(card, sp_cfg, {"tokens": torch.as_tensor(
            prompts).to(cuda)}, 40)
        sp_logits, _ = lm.lm_decode_step(card, caches, sp_cfg,
                                         got[:, :1])
    finally:
        clear_activation_sharding()
    assert torch.equal(got.cpu(), want)
    _, caches = lm.lm_prefill(cpu, cfg, {"tokens": torch.as_tensor(prompts)},
                              40)
    plain, _ = lm.lm_decode_step(cpu, caches, cfg, want[:, :1])
    torch.testing.assert_close(sp_logits.cpu(), plain, rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for s in ((2, 1, 8, 16), (2, 64, 4, 16), (2, 64, 4, 16)))
    pos = torch.tensor(40, dtype=torch.int32)
    parts = [(x.narrow(1, s * 16, 16)) for x in (k, v) for s in range(4)]
    want = SP.sp_decode_attention(q, parts[:4], parts[4:], pos, 4)
    cq, ck, cv = q.to(cuda), k.to(cuda), v.to(cuda)
    got = SP.sp_decode_attention(
        cq, [ck.narrow(1, s * 16, 16) for s in range(4)],
        [cv.narrow(1, s * 16, 16) for s in range(4)], pos.to(cuda), 4)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    for where in ("cpu", cuda):
        kc = torch.zeros((1, 32, 2, 4), device=where)
        vc = torch.zeros_like(kc)
        for s in range(4):
            SP.sp_cache_update(kc.narrow(1, s * 8, 8), vc.narrow(1, s * 8, 8),
                               torch.ones((1, 1, 2, 4), device=where),
                               torch.full((1, 1, 2, 4), 2.0, device=where),
                               torch.tensor(13, dtype=torch.int32,
                                            device=where), s)
        assert int((kc != 0).sum()) == 8 and bool((kc[0, 13] == 1).all())
        assert bool((vc[0, 13] == 2).all())


def test_launch_train_local_mesh_on_card(cuda, tmp_path):
    """``launch.train --mesh local`` on the card: a (1, device count) mesh
    over it, its per-device parameter bytes, finite losses; ``--mesh
    single`` needs 256 cards and raises with both counts."""
    from repro_torch.launch import train
    common = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "2",
              "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    res = train.main(common + ["--mesh", "local"])
    assert res["mesh"] == {"data": 1, "model": torch.cuda.device_count()}
    assert 0 < res["param_bytes_per_device"] <= 4 * res["params"]
    assert all(np.isfinite(res["losses"])) and res["device"] == "cuda"
    with pytest.raises(ValueError, match="must be >= the product of "
                                         "mesh_shape \\(16, 16\\)"):
        train.main(common + ["--mesh", "single"])
