"""The port's IVF index and bf16 catalog against the JAX package's, on the
CPU: the build's helpers bitwise, k-means within 1e-5, the index's buckets
and search with f32 and bf16 buckets, the exact index on a bf16 catalog,
the memory-mapped embedding cache, ``Recommender(ann=True)`` and the serving
tier on it, and ``scripts/torch_bench_ivf.py`` at a small size.

Inputs are numpy arrays from seeded generators, handed to both packages.
The clustered catalogs below have no near-ties (their score gaps are far
above the two packages' f32 rounding differences, about 1e-7), so the
bucket ids and the returned ids are held identical.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.index import (
    IVFCatalogIndex as JaxIVF,
    ShardedCatalogIndex as JaxSharded,
)
from instacart_next_order_recommendation_tpu.index import ivf as jax_ivf
from instacart_next_order_recommendation_tpu.serve.recommender import (
    Recommender as JaxRecommender,
)
from instacart_next_order_recommendation_tpu_torch.index import (
    EmbeddingIndex,
    IVFCatalogIndex,
    ShardedCatalogIndex,
)
from instacart_next_order_recommendation_tpu_torch.index import ivf as port_ivf
from instacart_next_order_recommendation_tpu_torch.serve import (
    MicroBatcher,
    MonitoredRecommender,
)
from instacart_next_order_recommendation_tpu_torch.serve import recommender as port_recommender
from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
    K_BUCKETS,
    warm_serve_shapes,
)
from instacart_next_order_recommendation_tpu_torch.tokenizer import LENGTH_BUCKETS
from tests.helpers import make_corpus, make_tiny_model_dir, write_corpus_json

F32_TOL = 1e-5  # f32 scores of the same rows, summed in another order
BF16_TOL = 1e-2  # bf16 buckets against the f32 scan


def _clustered(seed, n=4000, d=32, n_clusters=50, b=32):
    """Unit rows around random unit centers, and queries near the centers
    (the JAX package's IVF tests draw theirs the same way)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = centers[rng.integers(0, n_clusters, n)] + 0.25 * rng.standard_normal((n, d)).astype(
        np.float32
    )
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = centers[rng.integers(0, n_clusters, b)] + 0.25 * rng.standard_normal((b, d)).astype(
        np.float32
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32), emb.astype(np.float32)


# ------------------------------------------------------------ build helpers


def test_finish_centroids_bitwise_with_reseeded_empties():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    sums = rng.standard_normal((12, 16))
    counts = rng.integers(0, 5, 12).astype(np.float64)
    counts[[2, 7]] = 0  # empty clusters draw rows from the rng
    want = jax_ivf._finish_centroids(sums, counts, emb, np.random.default_rng(3))
    for e in (emb, torch.from_numpy(emb)):
        got = port_ivf._finish_centroids(sums, counts, e, np.random.default_rng(3))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,nlist,cap", [(500, 16, 40), (500, 16, 32), (64, 8, 8)])
def test_balanced_assign_bitwise(n, nlist, cap):
    # Preferences crowd into a few clusters, so rows spill down their lists
    # and (cap * nlist == n) some land in any free slot.
    rng = np.random.default_rng(n + cap)
    pref = np.stack(
        [rng.permutation(nlist)[:4] % 5 * 3 % nlist for _ in range(n)]
    ).astype(np.int32)
    got = port_ivf._balanced_assign(pref, nlist, cap)
    assert np.array_equal(got, jax_ivf._balanced_assign(pref, nlist, cap))
    assert np.bincount(got, minlength=nlist).max() <= cap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fill_buckets_bitwise(dtype):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((700, 24)).astype(np.float32)
    assign = rng.integers(0, 10, 700)
    j_buckets, j_ids = jax_ivf._fill_buckets(assign, emb, 10, 90, chunk=128)
    p_buckets, p_ids = port_ivf._fill_buckets(
        assign, emb, 10, 90, chunk=128, dtype=getattr(torch, dtype)
    )
    assert np.array_equal(p_ids, j_ids)
    want = torch.from_numpy(j_buckets).to(getattr(torch, dtype))  # JAX casts after the fill
    assert p_buckets.dtype == want.dtype and torch.equal(p_buckets, want)


@pytest.mark.parametrize("chunk", [65536, 1000])  # one chunk; a ragged last chunk
def test_kmeans_against_jax(chunk):
    _, emb = _clustered(0)
    want = jax_ivf._kmeans(emb, 64, 4, seed=0)
    got = port_ivf._kmeans(emb, 64, 4, seed=0, chunk=chunk)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= F32_TOL


def test_prefs_on_the_device_equal_host_prefs():
    _, emb = _clustered(2)
    centroids = jax_ivf._kmeans(emb, 32, 2, seed=0)
    want = JaxIVF._host_prefs(emb, centroids, 8)
    got = IVFCatalogIndex._prefs(emb, centroids, 8, 700, torch.device("cpu"))
    assert got.dtype == np.int32 and np.array_equal(got, want)


# ------------------------------------------------------------------ the index


@pytest.fixture(scope="module")
def built():
    """Both packages' IVF index on one catalog, f32 and bf16 buckets."""
    q, emb = _clustered(0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        ours = IVFCatalogIndex(emb, nlist=64, nprobe=16, seed=0, dtype=dtype, device="cpu")
        theirs = JaxIVF(emb, nlist=64, nprobe=16, seed=0, dtype=dtype)
        out[dtype] = (ours, theirs)
    return q, emb, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_buckets_match_jax(built, dtype):
    _, emb, idx = built
    ours, theirs = idx[dtype]
    assert (ours.nlist, ours.nprobe, ours.bucket_len) == (theirs.nlist, theirs.nprobe,
                                                          theirs.bucket_len)
    ids = ours._bucket_ids.numpy()
    assert np.array_equal(ids, np.asarray(theirs._bucket_ids))
    assert np.abs(ours._centroids.numpy() - np.asarray(theirs._centroids)).max() <= F32_TOL
    assert torch.equal(
        ours._buckets.float(), torch.from_numpy(np.array(theirs._buckets.astype("float32")))
    )
    real = ids[ids >= 0]  # every row in exactly one bucket
    assert len(real) == len(emb) and len(np.unique(real)) == len(emb)
    assert set(ours.build_s) == {"kmeans", "prefs", "assign", "fill"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nprobe", [4, 64])  # partial, full
@pytest.mark.parametrize("masked", [False, True])
def test_search_matches_jax(built, dtype, nprobe, masked):
    q, emb, idx = built
    ours, theirs = idx[dtype]
    ours.nprobe = theirs.nprobe = nprobe
    theirs._topk_cache.clear()
    mask = (np.random.default_rng(5).random(len(emb)) < 0.3).astype(np.int32) if masked else None
    try:
        js, ji = theirs.topk(q, 10, candidate_mask=mask)
        ps, pi = ours.topk(q, 10, candidate_mask=mask)
        ds, di = ours.topk_device(q, 10, candidate_mask=mask)
    finally:
        ours.nprobe = theirs.nprobe = 16
        theirs._topk_cache.clear()
    assert pi.dtype == np.int32 and ps.dtype == np.float32
    assert np.array_equal(pi, ji) and np.array_equal(di.numpy(), pi)
    assert np.abs(ps - js).max() <= F32_TOL
    if masked:
        assert (mask[pi] == 1).all()
    if nprobe == 64:  # full probe: the exact scan of the f32 queries over the stored rows
        rows = torch.from_numpy(emb).to(getattr(torch, dtype)).float()
        es, ei = ShardedCatalogIndex(rows, device="cpu").topk(q, 10, candidate_mask=mask)
        assert np.array_equal(pi, ei) and np.abs(ps - es).max() <= F32_TOL
        fs, _ = ShardedCatalogIndex(emb, device="cpu").topk(q, 10, candidate_mask=mask)
        assert np.abs(ps - fs).max() <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_search_gathers_in_chunks_of_queries(built, monkeypatch):
    q, _, idx = built
    ours, _ = idx["float32"]
    whole = ours.topk(q, 10)
    monkeypatch.setattr(port_ivf, "GATHER_BYTES", 1)  # one query a gather
    parts = ours.topk(q, 10)
    # The same rows scored: only a score's summation order may change.
    assert np.array_equal(parts[1], whole[1]) and np.abs(parts[0] - whole[0]).max() <= F32_TOL


def test_k_is_capped_and_the_tail_is_the_sentinel():
    q, emb = _clustered(3, n=300, b=4)
    ours = IVFCatalogIndex(emb, nlist=30, nprobe=2, seed=0, device="cpu")
    theirs = JaxIVF(emb, nlist=30, nprobe=2, seed=0)
    k = ours.nprobe * ours.bucket_len + 5
    s, i = ours.topk(q, k)
    js, ji = theirs.topk(q, k)
    assert s.shape == (4, ours.nprobe * ours.bucket_len) and np.array_equal(i, ji)
    assert np.array_equal(s <= -1e29, i < 0) and (s <= -1e29).any()


def test_inputs_memmap_and_tensor_build_the_same_index(tmp_path):
    q, emb = _clustered(7, n=2000)
    np.save(tmp_path / "emb.npy", emb)
    mapped = np.load(tmp_path / "emb.npy", mmap_mode="r")
    ram = IVFCatalogIndex(emb, nlist=32, nprobe=8, seed=0, device="cpu", build_chunk=300)
    for other in (mapped, torch.from_numpy(emb)):
        idx = IVFCatalogIndex(other, nlist=32, nprobe=8, seed=0, device="cpu", build_chunk=300)
        assert torch.equal(idx._bucket_ids, ram._bucket_ids)
        assert np.array_equal(idx.topk(q, 10)[1], ram.topk(q, 10)[1])


def test_index_refuses_a_mesh_a_dtype_and_a_missing_card(monkeypatch):
    _, emb = _clustered(0, n=200)
    with pytest.raises(ValueError, match="mesh"):
        IVFCatalogIndex(emb, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        IVFCatalogIndex(emb, dtype="float16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IVFCatalogIndex(emb)


# ----------------------------------------------------- bf16 catalog, mmap cache


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_exact_index_matches_jax(masked):
    q, emb = _clustered(4)
    mask = (np.random.default_rng(6).random(len(emb)) < 0.5).astype(np.int32) if masked else None
    ours = ShardedCatalogIndex(emb, device="cpu", dtype="bfloat16")
    assert ours.catalog.dtype == torch.bfloat16
    ps, pi = ours.topk(q, 10, candidate_mask=mask)
    js, ji = JaxSharded(emb, dtype="bfloat16").topk(q, 10, candidate_mask=mask)
    assert np.array_equal(pi, ji) and np.abs(ps - js).max() <= F32_TOL
    fs, _ = ShardedCatalogIndex(emb, device="cpu").topk(q, 10, candidate_mask=mask)
    assert np.abs(ps - fs).max() <= BF16_TOL
    with pytest.raises(ValueError, match="dtype"):
        ShardedCatalogIndex(emb, device="cpu", dtype="float16")


def test_embedding_index_mmap_load(tmp_path):
    corpus_path = tmp_path / "corpus.json"
    corpus_path.write_text("{}")
    idx = EmbeddingIndex(corpus_path, tmp_path / "model")
    ids = [str(i) for i in range(64)]
    emb = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    idx.save(ids, emb)
    loaded = idx.load(ids, mmap=True)
    assert isinstance(loaded, np.memmap) and not loaded.flags.writeable
    assert np.array_equal(np.asarray(loaded), emb)
    assert not isinstance(idx.load(ids), np.memmap)
    assert idx.load(ids[:-1], mmap=True) is None


# ------------------------------------------------ Recommender and serving tier


@pytest.fixture(scope="module")
def ann_served(tmp_path_factory):
    """The tiny tower over 60 products: JAX's and the port's recommender
    with ``ann=True`` at full probe, and the port's exact one."""
    base = tmp_path_factory.mktemp("ann")
    corpus = make_corpus(60)
    model_dir = make_tiny_model_dir(base, corpus)
    corpus_path = write_corpus_json(base, corpus)
    kw = dict(ann=True, ann_nlist=8, ann_nprobe=8)
    ours = port_recommender.Recommender(model_dir, corpus_path, device="cpu", **kw)
    theirs = JaxRecommender(model_dir=model_dir, corpus_path=corpus_path, **kw)
    exact = port_recommender.Recommender(model_dir, corpus_path, device="cpu")
    return corpus, ours, theirs, exact


def _ids(results):
    return [pid for pid, _ in results]


@pytest.mark.parametrize("query", ["organic milk", "bread and coffee rice"])
def test_ann_recommender_matches_jax(ann_served, query):
    corpus, ours, theirs, exact = ann_served
    assert isinstance(ours.index, IVFCatalogIndex) and ours._fused is None
    got = ours.recommend(query, top_k=5)
    assert len(got) == 5 and _ids(got) == _ids(theirs.recommend(query, top_k=5))
    assert _ids(got) == _ids(exact.recommend(query, top_k=5))  # full probe: exact
    filtered = ours.recommend(query, top_k=5, filter_aisles=["a1"])
    assert _ids(filtered) == _ids(theirs.recommend(query, top_k=5, filter_aisles=["a1"]))
    assert filtered and all("Aisle: a1." in corpus[p] for p in _ids(filtered))
    excluded = set(_ids(got)[:2])
    assert _ids(ours.recommend(query, top_k=5, exclude_product_ids=excluded)) == _ids(
        theirs.recommend(query, top_k=5, exclude_product_ids=excluded)
    )


def test_ann_serving_tier(ann_served, monkeypatch):
    corpus, ours, _, exact = ann_served
    mon = MonitoredRecommender(ours.model_dir, ours.corpus_path, device="cpu",
                               encoder=ours.encoder, ann=True, ann_nlist=8, ann_nprobe=8)
    got = mon.recommend("organic milk", top_k=5)
    assert _ids(got) == _ids(exact.recommend("organic milk", top_k=5))
    assert mon.last_metrics.stage_timing_source == "measured"  # the index route
    # The warm-up runs the index's jobs only: no fused pipeline to warm.
    seqs = [s for s in LENGTH_BUCKETS if s <= mon.encoder.max_seq_length]
    k_effs = [k for k in K_BUCKETS if k < len(corpus)] + [len(corpus)]
    assert warm_serve_shapes(mon) == len(seqs) + 2 * len(k_effs)
    # A drain of several requests goes through the IVF index's topk.
    calls = []
    topk = mon.index.topk
    monkeypatch.setattr(mon.index, "topk", lambda *a, **kw: calls.append(1) or topk(*a, **kw))
    batcher = MicroBatcher(mon, window_ms=50.0)
    queries = ["organic milk", "bread and coffee rice", "banana", "cheese"]
    results = {}

    def ask(q):
        results[q] = batcher.recommend(q, top_k=4)

    threads = [threading.Thread(target=ask, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert calls and sum(batcher.drain_sizes.values()) == len(calls)
    for q in queries:
        assert _ids(results[q]) == _ids(exact.recommend(q, top_k=4))


def test_serve_cli_with_ann(ann_served, tmp_path, monkeypatch, capsys):
    _, ours, theirs, _ = ann_served
    config = tmp_path / "inference.yaml"
    config.write_text(
        f"model_dir: {json.dumps(str(ours.model_dir))}\ncorpus: {json.dumps(str(ours.corpus_path))}\n"
        "use_index: false\nquery: organic milk\ntop_k: 5\nann: true\nann_nlist: 8\nann_nprobe: 8\n"
    )
    monkeypatch.setenv("INFERENCE_DEVICE", "cpu")
    built = []
    real = port_recommender.IVFCatalogIndex

    def spy(*args, **kwargs):
        built.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_recommender, "IVFCatalogIndex", spy)
    monkeypatch.setattr(sys, "argv", ["serve", "--config", str(config)])
    port_recommender.main()
    lines = [x for x in capsys.readouterr().out.splitlines() if "product_id=" in x]
    assert built and built[0]["nlist"] == 8 and built[0]["nprobe"] == 8
    want = _ids(theirs.recommend("organic milk", top_k=5))
    assert [x.split("product_id=")[1].split(" ")[0] for x in lines] == want


def test_bench_script_at_a_small_size(monkeypatch, capsys):
    from scripts import torch_bench_ivf as bench

    for name, value in dict(N_CATALOG=3000, N_CENTERS=40, DIM=32, N_QUERIES=300,
                            SWEEP=((32, (4, 32)), (64, (8,)))).items():
        monkeypatch.setattr(bench, name, value)
    out = bench.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["metric"] == "ivf_recall_qps" and out["value"] is None
    details = out["details"]
    assert details["catalog_size"] == 3000 and details["exact_ms_b8"] is None
    recalls = {(r["nlist"], r["nprobe"]): r["recall_at_10"] for r in details["sweep"]}
    assert set(recalls) == {(32, 4), (32, 32), (64, 8)}
    # Full probe of bf16 buckets recovers the bf16 exact scan's top-10.
    assert recalls[(32, 32)] >= 0.99 and recalls[(32, 4)] <= recalls[(32, 32)]
    # The generator is the JAX script's: the same rows from the same seed.
    from scripts import bench_ivf

    monkeypatch.setattr(bench_ivf, "SPREAD", bench.SPREAD)
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((40, 32), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    state = rng.bit_generator.state
    a = bench.make_clustered(100, centers, rng)
    rng.bit_generator.state = state
    assert np.array_equal(a, bench_ivf.make_clustered(100, centers, rng))
