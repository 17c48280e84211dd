"""The port's serve profile (``scripts/torch_profile_serve.py``) on the CPU at
a small catalog, and its workload (``utils/bench_texts.py``) against
``bench.py``'s."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import bench
import scripts.torch_profile_serve as ps
from instacart_next_order_recommendation_tpu.models.encoder import TowerConfig as JaxTowerConfig
from instacart_next_order_recommendation_tpu.serve.pipeline import (
    FusedServePipeline as JaxFusedServePipeline,
)
from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_to_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import MINILM_L6
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.utils import bench_texts

TINY = dataclasses.replace(
    MINILM_L6, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    compute_dtype="float32",
)
K = ps.TOP_K


@pytest.mark.parametrize("seed", [0, 7])
def test_bench_texts_equal_bench_py(seed):
    assert (bench_texts.CATALOG_SIZE, bench_texts.TOP_K) == (bench.CATALOG_SIZE, bench.TOP_K)
    ours = bench_texts.build_catalog_texts(300, np.random.default_rng(seed))
    theirs = bench.build_catalog_texts(300, np.random.default_rng(seed))
    assert ours == theirs
    rng_a, rng_b = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    assert bench_texts.build_query_texts(50, ours, rng_a) == bench.build_query_texts(
        50, theirs, rng_b
    )
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)  # the same draws consumed


@pytest.fixture(scope="module")
def workload():
    return ps.build_workload(n_products=300, n_queries=64, vocab_size=1000, device="cpu",
                             preset=TINY)


def test_readings_at_small_sizes(workload):
    assert ps.card_line(workload.device) == "device: cpu"
    lens = ps.token_lengths(workload, 32)
    assert 0 < lens["p50"] <= lens["p90"] <= lens["max"]
    tok, ids = ps.tokenize_qps(workload, 48)
    assert tok["queries"] == 48 and tok["qps"] > 0 and tuple(ids.shape) == tuple(tok["shape"])
    rows = ps.device_qps(workload, ids, batches=(8, 16), seqs=(32, 64), iters=2)
    assert [(r["batch"], r["seq"]) for r in rows] == [(8, 32), (8, 64), (16, 32), (16, 64)]
    assert all(r["qps"] > 0 and r["ms_per_batch"] > 0 for r in rows)
    e2e = ps.e2e_qps(workload, batches=(16, 32), threads=(1, 2))
    assert [(r["batch"], r["threads"]) for r in e2e] == [(16, 1), (16, 2), (32, 1), (32, 2)]
    assert all(r["qps"] > 0 for r in e2e)


def test_fused_ids_equal_the_plain_path_and_jax(workload):
    fused = workload.fused
    queries = workload.queries[:24]
    ids, mask = workload.tokenizer.encode_batch(queries, max_seq_length=ps.MAX_SEQ_LENGTH)
    packed, k = fused.topk_device(ids, mask, K)
    scores, got = fused.unpack(packed.cpu().numpy(), k)
    # The plain path: encode, then the index's top-k, in two calls.
    encoder = TextEncoder(fused.params, fused.config, workload.tokenizer,
                          max_seq_length=ps.MAX_SEQ_LENGTH, device="cpu")
    index = ShardedCatalogIndex(fused.catalog, device="cpu")
    plain_scores, plain = index.topk(encoder.encode(queries), K)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(scores, plain_scores, atol=1e-6)
    # The JAX pipeline on the same weights and catalog.
    jparams = {g: {n: jnp.asarray(a) for n, a in v.items()}
               for g, v in params_to_numpy(fused.params).items()}
    jax_fused = JaxFusedServePipeline(
        jparams, JaxTowerConfig.from_dict(fused.config.to_dict()),
        jnp.asarray(fused.catalog.numpy()), fused.n_valid, pad_id=workload.tokenizer.pad_id,
    )
    jscores, jids = jax_fused.topk(ids, mask, K)
    np.testing.assert_array_equal(got, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), atol=1e-5)


def test_main_without_a_card_asks_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.main([])
