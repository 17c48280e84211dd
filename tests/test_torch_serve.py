"""The port's serve path (index, fused pipeline, Recommender) against the JAX
package's, on the CPU, and the port's import isolation."""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    init_params as jax_init_params,
    save_tower as jax_save_tower,
)
from instacart_next_order_recommendation_tpu.serve.precompile import K_BUCKETS as JAX_K_BUCKETS
from instacart_next_order_recommendation_tpu.serve.recommender import (
    Recommender as JaxRecommender,
)
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline
from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
    K_BUCKETS,
    Recommender,
)

REPO = Path(__file__).resolve().parents[1]
TOWER = JaxTowerConfig(
    vocab_size=0, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    max_position=64, max_seq_length=32, compute_dtype="float32",
)
AISLES = ["fresh fruits", "milk", "bread", "cereal", "coffee", "pasta sauce"]
QUERIES = [
    "[+7d w4h14] Organic Milk 3, Whole Wheat Bread 8.",
    "[+3d w1h9] Banana 11, Greek Yogurt 40, Honey.",
    "[+1d w0h12] Coffee 77, Oat Milk, Granola 150.",
]


def _corpus(n=200):
    adjs = ["Organic", "Fresh", "Whole", "Crunchy", "Roasted"]
    nouns = ["Milk", "Bread", "Banana", "Yogurt", "Coffee", "Granola", "Pasta"]
    return {
        str(1000 + i): f"Product: {adjs[i % 5]} {nouns[i % 7]} {i}. "
        f"Aisle: {AISLES[i % 6]}. Department: d{i % 4}."
        for i in range(n)
    }


def _jax_tower_dir(path: Path, corpus: dict) -> Path:
    tok = JaxWordPieceTokenizer.train(corpus.values(), vocab_size=600, min_frequency=1)
    cfg = dataclasses.replace(TOWER, vocab_size=tok.vocab_size)
    jax_save_tower(path, jax_init_params(cfg, jax.random.key(7)), cfg, tok)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One tower and corpus served by both packages, neither using a disk
    cache, so neither reads the other's embeddings."""
    base = tmp_path_factory.mktemp("serve")
    corpus = _corpus()
    corpus_path = base / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    model_dir = _jax_tower_dir(base / "model", corpus)
    ours = Recommender(model_dir, corpus_path, use_index=False, device="cpu")
    theirs = JaxRecommender(model_dir, corpus_path, use_index=False)
    return ours, theirs


def _ids(results):
    return [pid for pid, _ in results]


@pytest.mark.parametrize("query", QUERIES)
def test_recommend_matches_jax(served, query):
    ours, theirs = served
    a = ours.recommend(query, top_k=10)
    b = theirs.recommend(query, top_k=10)
    assert _ids(a) == _ids(b)
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=1e-5)
    excluded = {a[0][0], a[3][0]}
    assert _ids(ours.recommend(query, top_k=10, exclude_product_ids=excluded)) == _ids(
        theirs.recommend(query, top_k=10, exclude_product_ids=excluded)
    )
    assert not excluded & set(_ids(ours.recommend(query, 10, exclude_product_ids=excluded)))


def test_filtered_recommend_matches_jax(served):
    ours, theirs = served
    for kw in (
        {"filter_aisles": ["Milk"]},
        {"filter_aisles": ["coffee", "bread"], "filter_departments": ["d0"]},
    ):
        a = ours.recommend(QUERIES[0], top_k=12, **kw)
        b = theirs.recommend(QUERIES[0], top_k=12, **kw)
        assert _ids(a) == _ids(b) and len(a) > 0
        for pid, _ in a:
            text = ours.pid_to_text[pid].lower()
            assert any(f"aisle: {x.lower()}." in text for x in kw["filter_aisles"])
    # Fewer eligible rows than k: results stop at the -1e30 sentinel.
    few = ours.recommend(QUERIES[1], top_k=50, filter_aisles=["milk"], filter_departments=["d1"])
    assert _ids(few) == _ids(
        theirs.recommend(QUERIES[1], top_k=50, filter_aisles=["milk"], filter_departments=["d1"])
    )
    assert 0 < len(few) < 50
    assert ours.aisles == theirs.aisles and ours.departments == theirs.departments


def test_pipeline_packs_scores_and_indices(served):
    ours, _ = served
    ids, mask = ours.encoder.tokenizer.encode_batch(QUERIES, max_seq_length=32)
    packed, k = ours._fused.topk_device(ids, mask, 16)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (3, 32) and k == 16
    scores, indices = FusedServePipeline.unpack(packed.numpy(), k)
    emb = ours.encoder.encode(QUERIES)
    ref_s, ref_i = ours.index.topk(emb, 16)
    np.testing.assert_array_equal(indices, ref_i)
    np.testing.assert_allclose(scores, ref_s, atol=1e-6)
    assert K_BUCKETS == JAX_K_BUCKETS
    assert ours._k_bucket(17) == 32 and ours._k_bucket(300) == 200


def test_port_reads_the_jax_embedding_cache(tmp_path, monkeypatch):
    corpus = _corpus(60)
    corpus_path = tmp_path / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    model_dir = _jax_tower_dir(tmp_path / "model", corpus)
    theirs = JaxRecommender(model_dir, corpus_path, use_index=True)
    cache = np.asarray(theirs.product_embeddings)

    def no_encode(*args, **kwargs):
        raise AssertionError("the cache should have been read, not rebuilt")

    monkeypatch.setattr(TextEncoder, "encode_resident", no_encode)
    ours = Recommender(model_dir, corpus_path, use_index=True, device="cpu")
    assert isinstance(ours.product_embeddings, np.ndarray)
    np.testing.assert_array_equal(ours.product_embeddings, cache)
    assert _ids(ours.recommend(QUERIES[2], 5)) == _ids(theirs.recommend(QUERIES[2], 5))


def test_no_silent_cpu(served, monkeypatch):
    ours, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recommender(ours.model_dir, ours.corpus_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedCatalogIndex(np.zeros((4, 64), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextEncoder(ours.encoder.params, ours.encoder.config, ours.encoder.tokenizer)


def test_port_imports_no_jax(served, tmp_path):
    ours, _ = served
    script = textwrap.dedent(
        f"""
        import os
        import sys
        import torch
        from instacart_next_order_recommendation_tpu_torch.eval.evaluator import RetrievalEvaluator
        from instacart_next_order_recommendation_tpu_torch.index.ivf import IVFCatalogIndex
        from instacart_next_order_recommendation_tpu_torch.models import MPNET_BASE_CLASS
        from instacart_next_order_recommendation_tpu_torch.ops.attention import multi_head_attention
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
        from instacart_next_order_recommendation_tpu_torch.train import TrainConfig
        from instacart_next_order_recommendation_tpu_torch.serve import (
            InferenceConfig, MicroBatcher, MonitoredRecommender,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
            warm_serve_shapes,
        )
        from instacart_next_order_recommendation_tpu_torch.tokenizer import native, unicode_tables
        from instacart_next_order_recommendation_tpu_torch.utils.dotenv import load_dotenv
        from instacart_next_order_recommendation_tpu_torch.api import create_app
        from instacart_next_order_recommendation_tpu_torch.api import (
            app, auth, feedback_store, http, limiter, metrics, schemas, validation,
        )
        from instacart_next_order_recommendation_tpu_torch.api.routes import (
            corpus, feedback, model, recommend,
        )
        from instacart_next_order_recommendation_tpu_torch.baselines import (
            ContentBasedBaseline, ItemItemCFBaseline, load_eval_data,
        )
        from instacart_next_order_recommendation_tpu_torch.models.hf_loader import load_hf_tower
        from instacart_next_order_recommendation_tpu_torch.utils.profiling import (
            recording, span,
        )
        from instacart_next_order_recommendation_tpu_torch.parallel import (
            MeshConfig, ProcessMesh, build_mesh, init_distributed, shard_params,
        )
        from instacart_next_order_recommendation_tpu_torch.index.sharded import ShardedCatalogIndex
        from instacart_next_order_recommendation_tpu_torch.data import (
            DataPrepConfig, InstacartDataPrep, no_duplicates_batches,
        )
        from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
            generate_instacart_csvs,
        )
        import importlib
        workflows = [
            importlib.import_module(f"scripts.torch_{{name}}")
            for name in ("run_demo", "feedback_analytics", "generate_sample_feedback",
                         "feedback_retrain", "compare_untrained_vs_trained", "reval_tower",
                         "real_data_run", "profile_serve", "bench_soak", "launch_multihost",
                         "make_rehearsal_checkpoint", "rehearsal_real_shapes", "bench_mfu",
                         "gen_lockfile")
        ]
        import __graft_entry_torch__ as graft
        import bench_cuda
        from instacart_next_order_recommendation_tpu_torch.utils import bench_texts
        # The harness entry and the tools run on the card unless asked for
        # the CPU: here, with none, each raises before any work.
        if not torch.cuda.is_available():
            tools = {{name: sys.modules[f"scripts.torch_{{name}}"] for name in (
                "profile_serve", "bench_soak", "launch_multihost", "rehearsal_real_shapes")}}
            no_card = {str(tmp_path / "no_card")!r}
            calls = [
                graft.entry,
                lambda: graft.dryrun_multichip(2),
                lambda: tools["profile_serve"].main([]),
                lambda: tools["bench_soak"].main(["--workdir", no_card]),
                lambda: tools["launch_multihost"].main(["--workspace", no_card]),
                lambda: tools["rehearsal_real_shapes"].main(["--workdir", no_card]),
            ]
            for call in calls:
                try:
                    call()
                except RuntimeError as exc:
                    assert "CUDA is not available" in str(exc), exc
                else:
                    raise AssertionError("ran without a card")
            assert not os.path.exists(no_card)
            # The benchmark entries exit non-zero instead.
            assert bench_cuda.main([]) != 0
            assert sys.modules["scripts.torch_bench_mfu"].main(["--train"]) != 0
        assert graft.entry(device="cpu")[1][1].shape == (8, 128)
        assert len(bench_texts.build_catalog_texts(3, __import__("numpy").random.default_rng(0))) == 3
        # torchrun's environment, one rank: init_distributed has nothing to join.
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT="29500")
        init_distributed("cpu")
        import torch.distributed as dist
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        assert ProcessMesh(MeshConfig()).dp == 1
        for cli in ("serve", "api", "baselines", "train", "data"):  # each CLI's main: help, exit 0
            sys.argv = [cli, "--help"]
            try:
                __import__(f"instacart_next_order_recommendation_tpu_torch.{{cli}}.__main__")
            except SystemExit as exc:
                assert exc.code == 0, exc.code
        for module in workflows + [bench_cuda]:  # the scripts' mains: help, exit 0
            try:
                module.main(["--help"])
            except SystemExit as exc:
                assert exc.code == 0, (module.__name__, exc.code)
            else:
                raise AssertionError(module.__name__)
        rec = Recommender({str(ours.model_dir)!r}, {str(ours.corpus_path)!r},
                          use_index=False, device="cpu", topk_extraction="packed")
        assert len(rec.recommend({QUERIES[0]!r}, top_k=3)) == 3
        mon = MonitoredRecommender({str(ours.model_dir)!r}, {str(ours.corpus_path)!r},
                                   use_index=False, device="cpu", encoder=rec.encoder)
        assert len(MicroBatcher(mon).recommend({QUERIES[1]!r}, top_k=4)) == 4
        assert warm_serve_shapes(mon, k_buckets=(16,)) == 2 + 2 + 2
        ivf = IVFCatalogIndex(rec.product_embeddings, nlist=4, nprobe=4, device="cpu")
        assert ivf.topk(rec.product_embeddings[:2], 3)[1].shape == (2, 3)
        mesh = build_mesh(MeshConfig(2, 1), devices=["cpu", "cpu"])
        sharded = ShardedCatalogIndex(rec.product_embeddings, mesh)
        assert sharded.topk(rec.product_embeddings[:2], 3)[1].shape == (2, 3)
        assert rec.encoder.tokenizer.native_batches > 0 and native.library_path().exists()
        os.environ["INFERENCE_DEVICE"] = "cpu"
        os.environ["FEEDBACK_DB_PATH"] = {str(tmp_path / "feedback.db")!r}
        with http.TestClient(create_app({str(ours.model_dir)!r}, {str(ours.corpus_path)!r})) as c:
            r = c.post("/recommend", json={{"user_context": {QUERIES[0]!r}, "top_k": 3}})
            assert r.status_code == 200 and len(r.json()["recommendations"]) == 3, r.json()
        q = torch.zeros((1, 2, 8, 64))
        multi_head_attention(q, q, q, torch.ones((1, 8)), 0.125)
        assert TrainConfig({{"model_name": "mpnet-base"}}).model_name == "mpnet-base"
        assert MPNET_BASE_CLASS.head_dim == 64
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "instacart_next_order_recommendation_tpu",
                                      "bench", "__graft_entry__")]
        assert not bad, bad
        # The card's machine has neither: imported only where a file is read.
        lazy = [m for m in sys.modules if m.split(".")[0] in ("yaml", "datasets")]
        assert not lazy, lazy
        print("isolated")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout
