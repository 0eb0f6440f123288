"""Product quantization: codebook training (k-means), encoding, ADC tables.

PQ-compressed vectors are the paper's in-memory tier: graph navigation
compares distances against PQ codes only; full-precision vectors are fetched
from the record store ("SSD") solely for re-ranking.

Counterpart of ``repro.core.pq``. The k-means initial picks come from a
``torch.Generator`` and so differ from ``jax.random.choice``; everything
downstream of a codebook (encoding, tables, lookups) is pinned to the JAX
package's results.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import adc_slab_ref, sq_dist_fma

ENCODE_CHUNK = 1 << 16     # rows per encode step (bounds the (n, ksub) block)


class PQCodebook(NamedTuple):
    centroids: torch.Tensor   # (M, ksub, dsub) float32
    dim: int                  # original dimensionality (M * dsub, maybe padded)


def no_tf32() -> None:
    """Keep float32 matrix products in full float32 on the card (TF32 keeps
    about three decimal digits): the build's distances are such products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sub_dists(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """|x|² - 2 x·c + |c|² per subspace. x (M, N, dsub), cents (M, ksub,
    dsub) -> (M, N, ksub)."""
    return ((x * x).sum(-1, keepdim=True)
            - 2.0 * torch.bmm(x, cents.transpose(1, 2))
            + (cents * cents).sum(-1)[:, None, :])


def train_pq(data: torch.Tensor, m: int, ksub: int = 256, iters: int = 8,
             seed: int = 0) -> PQCodebook:
    """Train M subspace codebooks of ksub centroids each (Lloyd k-means).

    data (N, D) float32 on the device the training runs on; D divisible by m.
    """
    no_tf32()
    n, d = data.shape
    assert d % m == 0, f"dim {d} not divisible by m {m}"
    dsub = d // m
    dev = data.device
    sub = data.reshape(n, m, dsub).transpose(0, 1).contiguous()  # (M, N, dsub)
    gen = torch.Generator().manual_seed(int(seed))
    if n >= ksub:
        idx = torch.stack([torch.randperm(n, generator=gen)[:ksub]
                           for _ in range(m)])
    else:
        idx = torch.randint(0, n, (m, ksub), generator=gen)
    idx = idx.to(dev)
    cents = torch.gather(sub, 1, idx[..., None].expand(-1, -1, dsub))
    for _ in range(iters):
        # one-hot products in a fixed chunk order, not atomic adds, so the
        # codebook is the same on every run on the card
        sums = torch.zeros((m, ksub, dsub), device=dev)
        counts = torch.zeros((m, ksub, 1), device=dev)
        for s in range(0, n, ENCODE_CHUNK):
            x = sub[:, s:s + ENCODE_CHUNK]
            onehot = torch.nn.functional.one_hot(
                _sub_dists(x, cents).argmin(-1), ksub).float()
            sums += torch.bmm(onehot.transpose(1, 2), x)
            counts += onehot.sum(1)[..., None]
        new = sums / counts.clamp(min=1.0)
        cents = torch.where(counts > 0, new, cents)
    return PQCodebook(centroids=cents, dim=d)


def encode_pq(codebook: PQCodebook, data: torch.Tensor) -> torch.Tensor:
    """Encode vectors to PQ codes: (N, M) uint8 (int32 when ksub > 256)."""
    no_tf32()
    cents = codebook.centroids
    m, ksub, dsub = cents.shape
    n = data.shape[0]
    out = []
    for s in range(0, n, ENCODE_CHUNK):
        x = data[s:s + ENCODE_CHUNK]
        x = x.reshape(x.shape[0], m, dsub).transpose(0, 1)
        out.append(_sub_dists(x, cents).argmin(-1).transpose(0, 1))
    codes = torch.cat(out) if out else torch.zeros(
        (0, m), dtype=torch.long, device=data.device)
    return codes.to(torch.uint8 if ksub <= 256 else torch.int32)


def distance_table(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables: (M, ksub) squared-L2 partial distances per query.

    queries (D,) -> (M, ksub); (B, D) -> (B, M, ksub). The sum over dsub is
    the fused multiply-add chain of ``kernels.ref.sq_dist_fma`` (XLA-CPU's
    order), so the tables equal ``repro``'s bit for bit."""
    m, ksub, dsub = codebook.centroids.shape
    q = queries.reshape(queries.shape[:-1] + (m, 1, dsub))
    return sq_dist_fma(q, codebook.centroids).contiguous()


def adc_lookup(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ADC distance sum_m table[m, codes[:, m]] (left to right). codes
    (N, M), table (M, K) -> (N,); leading dims batch: codes (B, N, M),
    tables (B, M, K) -> (B, N)."""
    return adc_slab_ref(codes, table)


def decode_pq(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct approximate vectors from codes (for tests)."""
    m, ksub, dsub = codebook.centroids.shape
    idx = codes.long()
    parts = codebook.centroids[torch.arange(m, device=codes.device)[None, :],
                               idx]                               # (N, M, dsub)
    return parts.reshape(codes.shape[0], m * dsub)
