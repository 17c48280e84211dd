"""IVF (inverted-file) approximate index on one GPU.

Counterpart of the JAX package's ``index/ivf.py``, for catalogs too large
for the exact scan. The same names, arguments and results:

- **Build**: spherical k-means on the device. Each chunk of rows is scored
  against the centroids (one matmul), assigned to its best centroid
  (``argmax``, ties to the first) and summed per cluster by a one-hot
  matmul in f32; the per-chunk partials add up in f64 in chunk order, so the
  build is the same from run to run (no atomics). Then each row's
  ``min(8, nlist)`` nearest centroids (a top-k on the device), a
  capacity-balanced assignment on the host (each cluster holds at most
  ``bucket_len`` rows; overflow spills to the next preference), and one
  dense ``[nlist, bucket_len, D]`` bucket tensor filled on the device.
  With a mesh (``_MeshBuilder``) the rows stay sharded over its data
  devices for the build: each shard sums its k-means partials and counts
  over row chunks, the shards' partials add up in rank order each
  iteration, and each shard ranks its rows' preferences; the assignment
  and the fill are the same.
- **Search**: centroid scores ``[B, nlist]``, the top ``nprobe`` clusters
  per query, their buckets gathered (in chunks of queries, so one gather
  and its f32 copy stay under ``GATHER_BYTES``: a chunk moves no more than
  a score's last bits, by the order of its sum), candidate scores of the
  f32 queries against the rows in f32, padding slots and rows outside the
  candidate mask at -1e30, and the top k. Probing every cluster gives the
  exact ranking.

``embeddings`` may be a numpy array, a read-only ``np.memmap``
(``EmbeddingIndex.load(mmap=True)``), read chunk by chunk and never whole,
or a torch tensor, on the device or not. Every selection takes the
lowest index among equal scores on the CPU (a stable sort, as
``lax.top_k`` and ``jnp.argmax`` do, so the ids match the JAX package's);
on the card a selection is ``torch.topk``, whose order among exactly equal
scores is unspecified. The centroid scores and the candidate scores are
plain matmuls, as the JAX package leaves them to XLA: no TPU kernel is
behind them.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.index.sharded import DTYPES
from instacart_next_order_recommendation_tpu_torch.parallel.mesh import Mesh, data_devices

logger = logging.getLogger(__name__)

_NEG_INF = -1e30
GATHER_BYTES = 1 << 30  # the search's bucket gather (and its f32 copy), per chunk of queries


def _rows(embeddings, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Rows ``[lo, hi)`` as an f32 tensor on ``device``."""
    if isinstance(embeddings, torch.Tensor):
        return embeddings[lo:hi].to(device, torch.float32)
    return torch.from_numpy(np.array(embeddings[lo:hi], np.float32)).to(device)


def _gather(embeddings, idx: np.ndarray, device) -> torch.Tensor:
    """Rows ``idx`` as an f32 tensor on ``device``."""
    if isinstance(embeddings, torch.Tensor):
        sel = torch.from_numpy(np.asarray(idx, np.int64)).to(embeddings.device)
        return embeddings[sel].to(device, torch.float32)
    return torch.from_numpy(np.asarray(embeddings[idx], np.float32)).to(device)


def _take(embeddings, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` as an f32 array on the host."""
    return _gather(embeddings, idx, "cpu").numpy()


def _top(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores of each row, descending, and their positions:
    on the CPU a stable sort (ties to the lowest position), on the card
    ``torch.topk``."""
    if scores.device.type == "cpu":
        vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    return torch.topk(scores, k, dim=1)


def _finish_centroids(sums, counts, embeddings, rng) -> np.ndarray:
    """Normalize accumulated sums into unit-norm centroids; reseed empties."""
    sums = np.asarray(sums, np.float64)
    counts = np.asarray(counts, np.float64)
    empty = counts == 0
    if empty.any():  # re-seed empty clusters from random rows
        sums[empty] = _take(embeddings, rng.choice(len(embeddings), size=int(empty.sum())))
        counts[empty] = 1
    centroids = (sums / counts[:, None]).astype(np.float32)
    norms = np.linalg.norm(centroids, axis=1, keepdims=True)
    return centroids / np.maximum(norms, 1e-12)


def _kmeans(
    embeddings,
    nlist: int,
    iters: int,
    seed: int,
    chunk: int = 65536,
    device: str | torch.device = "cpu",
) -> np.ndarray:
    """Spherical k-means: returns unit-norm centroids [nlist, D].

    Each chunk's assignment and accumulation run on ``device`` (argmax,
    then a one-hot matmul for the sums and a bincount for the counts), so
    the host touches chunk-sized slices only and one [nlist, D] result per
    iteration. The last chunk is ragged: no zero padding, so no count to
    take back (the JAX build pads to one compiled shape and subtracts the
    padding from cluster 0's count).
    """
    n, d = embeddings.shape
    rng = np.random.default_rng(seed)
    centroids = _take(embeddings, np.sort(rng.choice(n, size=nlist, replace=False)))
    for _ in range(iters):
        c = torch.from_numpy(centroids).to(device)
        sums = torch.zeros((nlist, d), dtype=torch.float64, device=device)
        counts = torch.zeros(nlist, dtype=torch.int64, device=device)
        for lo in range(0, n, chunk):
            x = _rows(embeddings, lo, lo + chunk, device)
            assign = torch.argmax(x @ c.T, dim=1)
            onehot = torch.zeros((len(x), nlist), dtype=torch.float32, device=device)
            onehot[torch.arange(len(x), device=device), assign] = 1.0
            sums += (onehot.T @ x).double()
            counts += torch.bincount(assign, minlength=nlist)
        centroids = _finish_centroids(
            sums.cpu().numpy(), counts.cpu().numpy(), embeddings, rng
        )
    return centroids


class _MeshBuilder:
    """k-means and preferences with the rows sharded over data devices.

    Counterpart of the JAX package's ``_MeshBuilder``: shard ``i`` holds
    rows ``[i * shard_rows, (i + 1) * shard_rows)`` on its device for the
    whole build. Each k-means iteration runs every shard over its row
    chunks (scores, argmax, one-hot matmul sums and bincount counts, the
    chunks' partials added in f64 in order), then adds the shards' partials
    on the first device in rank order: no padding rows, so no count to
    take back. The centroids start from an unsorted draw of rows, as JAX's
    mesh build starts (its single-device ``_kmeans`` sorts the draw).
    """

    def __init__(self, embeddings, devices: list[torch.device], chunk: int):
        n = embeddings.shape[0]
        self.n = n
        self.devices = devices
        self.shard_rows = -(-n // len(devices))
        self.chunk = min(chunk, self.shard_rows)
        self.x = [
            _rows(embeddings, i * self.shard_rows, (i + 1) * self.shard_rows, dev)
            for i, dev in enumerate(devices)
        ]

    def _chunks(self, x: torch.Tensor):
        return (x[lo : lo + self.chunk] for lo in range(0, len(x), self.chunk))

    def kmeans(self, nlist: int, iters: int, seed: int, embeddings) -> np.ndarray:
        rng = np.random.default_rng(seed)
        centroids = _take(embeddings, rng.choice(self.n, size=nlist, replace=False))
        first = self.devices[0]
        for _ in range(iters):
            sums = torch.zeros((nlist, centroids.shape[1]), dtype=torch.float64, device=first)
            counts = torch.zeros(nlist, dtype=torch.int64, device=first)
            for x in self.x:  # rank order
                c = torch.from_numpy(centroids).to(x.device)
                part_s = torch.zeros_like(sums, device=x.device)
                part_c = torch.zeros_like(counts, device=x.device)
                for xc in self._chunks(x):
                    assign = torch.argmax(xc @ c.T, dim=1)
                    onehot = torch.zeros((len(xc), nlist), dtype=torch.float32, device=x.device)
                    onehot[torch.arange(len(xc), device=x.device), assign] = 1.0
                    part_s += (onehot.T @ xc).double()
                    part_c += torch.bincount(assign, minlength=nlist)
                sums += part_s.to(first)
                counts += part_c.to(first)
            centroids = _finish_centroids(
                sums.cpu().numpy(), counts.cpu().numpy(), embeddings, rng
            )
        return centroids

    def prefs(self, centroids: np.ndarray, prefs: int) -> np.ndarray:
        """Top-``prefs`` nearest centroids per row, [n, prefs] int32."""
        parts = []
        for x in self.x:
            c = torch.from_numpy(centroids).to(x.device)
            parts += [_top(xc @ c.T, prefs)[1].to(torch.int32).cpu() for xc in self._chunks(x)]
        return torch.cat(parts).numpy()


def _balanced_assign(pref_idx: np.ndarray, nlist: int, cap: int) -> np.ndarray:
    """Capacity-balanced cluster assignment from per-row preference lists.

    Round ``r`` offers every still-unassigned row its rank-``r`` centroid;
    a cluster admits rows (in row order) until its ``cap`` is exhausted and
    the rest spill to their next preference. Vectorized: O(prefs) argsorts,
    no per-row loop. Rows whose whole preference list is full land in
    arbitrary free slots (capacity ``nlist*cap >= n`` guarantees room).
    """
    n, n_prefs = pref_idx.shape
    assign = np.full(n, -1, np.int64)
    remaining = np.full(nlist, cap, np.int64)
    unassigned = np.arange(n)
    for r in range(n_prefs):
        if not len(unassigned):
            break
        ci = pref_idx[unassigned, r]
        order = np.argsort(ci, kind="stable")  # stable: row order within cluster
        sci = ci[order]
        run_start = np.r_[0, np.flatnonzero(np.diff(sci)) + 1]
        run_len = np.diff(np.r_[run_start, len(sci)])
        rank_in_cluster = np.arange(len(sci)) - np.repeat(run_start, run_len)
        admit = rank_in_cluster < remaining[sci]
        rows = unassigned[order[admit]]
        assign[rows] = sci[admit]
        remaining -= np.bincount(sci[admit], minlength=nlist)
        unassigned = unassigned[order[~admit]]
    if len(unassigned):  # rare: all preferences full; any free slot works
        free = np.repeat(np.arange(nlist), remaining)
        assign[unassigned] = free[: len(unassigned)]
    return assign


def _fill_buckets(
    assign: np.ndarray,
    embeddings,
    nlist: int,
    cap: int,
    chunk: int = 262_144,
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, np.ndarray]:
    """Scatter rows into the dense bucket tensors: ``buckets`` [nlist, cap,
    D] in ``dtype`` on ``device`` (zero in empty slots) and ``bucket_ids``
    [nlist, cap] int32 on the host (-1 in empty slots). Rows are gathered in
    chunks, so a memmapped ``embeddings`` never needs a full-size copy in
    host memory; each slot is written once."""
    d = embeddings.shape[1]
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    run_start = np.r_[0, np.flatnonzero(np.diff(sa)) + 1]
    run_len = np.diff(np.r_[run_start, len(sa)])
    slot = np.arange(len(sa)) - np.repeat(run_start, run_len)
    buckets = torch.zeros((nlist, cap, d), dtype=dtype, device=device)
    bucket_ids = np.full((nlist, cap), -1, np.int32)
    for lo in range(0, len(order), chunk):
        rows = _gather(embeddings, order[lo : lo + chunk], device)
        at = (torch.from_numpy(a[lo : lo + chunk]).to(device) for a in (sa, slot))
        buckets[tuple(at)] = rows.to(dtype)
    bucket_ids[sa, slot] = order
    return buckets, bucket_ids


class IVFCatalogIndex:
    """Approximate top-k over bucketed clusters. The same ``topk`` and
    ``topk_device`` as ShardedCatalogIndex (the Recommender takes either)."""

    def __init__(
        self,
        embeddings,
        nlist: int | None = None,
        nprobe: int = 8,
        bucket_slack: float = 1.3,
        kmeans_iters: int = 8,
        seed: int = 0,
        dtype: str = "float32",
        mesh: Mesh | None = None,
        build_chunk: int = 8192,
        device: str | torch.device | None = None,
    ):
        """``dtype``: the buckets' storage dtype on the device (``"float32"``
        or ``"bfloat16"``); centroids and scores are f32.
        ``build_chunk``: rows per k-means and preference step on the device.
        ``device=None`` means the GPU and raises where there is none.
        ``mesh``: a device mesh (``parallel.build_mesh``) whose data devices
        shard the k-means and preference build (the rows stay there for
        it); the buckets and the search live on ``device``, or on the first
        data device when ``device`` is None.
        ``build_s`` holds the build's seconds by stage."""
        shard_devices = data_devices(mesh)
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        if device is None and shard_devices is not None:
            device = shard_devices[0]
        self.device = resolve_device(device)
        n, d = embeddings.shape
        self.n_total = n
        self.dim = d
        self.nlist = nlist or max(1, int(np.sqrt(n)))
        self.nprobe = min(nprobe, self.nlist)
        self.bucket_len = max(1, int(np.ceil(n / self.nlist * bucket_slack)))
        n_prefs = min(8, self.nlist)

        t0 = time.perf_counter()
        if shard_devices is not None:
            builder = _MeshBuilder(embeddings, shard_devices, build_chunk)
            centroids = builder.kmeans(self.nlist, kmeans_iters, seed, embeddings)
            t1 = time.perf_counter()
            pref_idx = builder.prefs(centroids, n_prefs)
            del builder
        else:
            centroids = _kmeans(
                embeddings, self.nlist, kmeans_iters, seed, chunk=build_chunk, device=self.device
            )
            t1 = time.perf_counter()
            pref_idx = self._prefs(embeddings, centroids, n_prefs, build_chunk, self.device)
        t2 = time.perf_counter()
        assign = _balanced_assign(pref_idx, self.nlist, self.bucket_len)
        t3 = time.perf_counter()
        self._buckets, bucket_ids = _fill_buckets(
            assign, embeddings, self.nlist, self.bucket_len, device=self.device,
            dtype=DTYPES[dtype],
        )
        self._centroids = torch.from_numpy(centroids).to(self.device)
        self._bucket_ids = torch.from_numpy(bucket_ids).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_s = {
            "kmeans": t1 - t0, "prefs": t2 - t1, "assign": t3 - t2,
            "fill": time.perf_counter() - t3,
        }
        fill = (bucket_ids >= 0).mean()
        logger.info(
            "IVF index: %d rows, nlist=%d, bucket_len=%d (fill %.0f%%), nprobe=%d%s",
            n, self.nlist, self.bucket_len, 100 * fill, self.nprobe,
            f", built on {len(shard_devices)} data shards" if shard_devices else "",
        )

    @staticmethod
    def _prefs(
        embeddings, centroids: np.ndarray, prefs: int, chunk: int, device: torch.device
    ) -> np.ndarray:
        """Top-``prefs`` nearest centroids per row, [n, prefs] int32: a
        matmul and a top-k per chunk on the device (the JAX single-device
        build ranks on the host, ``_host_prefs``; its mesh build as here)."""
        c = torch.from_numpy(centroids).to(device)
        parts = [
            _top(_rows(embeddings, lo, lo + chunk, device) @ c.T, prefs)[1]
            for lo in range(0, embeddings.shape[0], chunk)
        ]
        return torch.cat(parts).to(torch.int32).cpu().numpy()

    def topk_device(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int,
        candidate_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k as device tensors: (scores [B, k'] f32, ids [B, k'] int32),
        k' = min(k, nprobe * bucket_len, n_total). ``candidate_mask`` is an
        optional ``[n_total]`` row filter (1 = eligible). Slots past the
        eligible candidates score -1e30 (their id may be -1)."""
        k = min(k, self.nprobe * self.bucket_len, self.n_total)
        q = torch.as_tensor(queries).to(device=self.device, dtype=torch.float32)
        mask = None
        if candidate_mask is not None:
            mask = torch.as_tensor(candidate_mask).to(device=self.device, dtype=torch.int32)
        _, probe = _top(q @ self._centroids.T, self.nprobe)  # [B, nprobe]
        elem = self._buckets.element_size()
        per_query = self.nprobe * self.bucket_len * self.dim * (elem + (4 if elem != 4 else 0))
        rows = max(1, GATHER_BYTES // per_query)
        parts = [
            self._search(q[lo : lo + rows], probe[lo : lo + rows], k, mask)
            for lo in range(0, q.shape[0], rows)
        ]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([s for s, _ in parts]), torch.cat([i for _, i in parts])

    def _search(self, q, probe, k: int, mask) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k of the queries ``q`` [b, D] over their probed buckets."""
        b = q.shape[0]
        cand = self._buckets[probe].reshape(b, -1, self.dim)  # [b, nprobe * L, D]
        cand_ids = self._bucket_ids[probe].reshape(b, -1)
        scores = torch.bmm(cand.to(torch.float32), q[:, :, None])[:, :, 0]
        valid = cand_ids >= 0
        if mask is not None:
            valid &= mask[cand_ids.clamp(min=0).long()] != 0
        scores = torch.where(valid, scores, _NEG_INF)
        top_s, pos = _top(scores, k)
        return top_s, torch.gather(cand_ids, 1, pos)

    def topk(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int,
        candidate_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        s, i = self.topk_device(queries, k, candidate_mask=candidate_mask)
        return s.cpu().numpy(), i.cpu().numpy()
