"""The port's device mesh in one process against the JAX package's mesh code,
on the CPU: mesh shapes and their errors, each model rank's tensor-parallel
shard against JAX's ``addressable_shards``, the row-sharded catalog index
and IVF's mesh build against JAX's on meshes of the same shape (JAX on the
8 virtual CPU devices ``tests/conftest.py`` makes, the port's shards all on
``cpu``), the text encoder and the Recommender over a mesh, and the kernel
build's lock across processes.

Inputs are numpy arrays from seeded generators, handed to both packages.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.index import (
    IVFCatalogIndex as JaxIVF,
    ShardedCatalogIndex as JaxSharded,
)
from instacart_next_order_recommendation_tpu.models import (
    MINILM_L6 as JAX_MINILM_L6,
    init_params as jax_init_params,
)
from instacart_next_order_recommendation_tpu.parallel import (
    MeshConfig as JaxMeshConfig,
    build_mesh as jax_build_mesh,
    param_shardings,
)
from instacart_next_order_recommendation_tpu_torch.index import (
    IVFCatalogIndex,
    ShardedCatalogIndex,
)
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_from_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.parallel import (
    MeshConfig,
    build_mesh,
    gather_params,
    shard_params,
)
from instacart_next_order_recommendation_tpu_torch.parallel.shardings import validate_tp
from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
from instacart_next_order_recommendation_tpu_torch.train.trainer import TrainConfig
from tests.helpers import make_corpus, make_tiny_model_dir, write_corpus_json

REPO = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-6  # f32 scores of the same rows, summed in another order
CENTROID_TOL = 1e-5

TINY = dataclasses.replace(
    JAX_MINILM_L6,
    vocab_size=256,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    intermediate_size=128,
    max_position=64,
    compute_dtype="float32",
)


def cpu_mesh(dp: int, tp: int = 1):
    return build_mesh(MeshConfig(dp, tp), devices=["cpu"] * (dp * tp))


# ------------------------------------------------------------------ mesh


def test_mesh_shapes_and_errors_as_jax():
    devices = ["cpu"] * 8
    for config in (MeshConfig(), MeshConfig(4, 2), MeshConfig(2, 4), MeshConfig(3, 2)):
        ours = build_mesh(config, devices=devices)
        theirs = jax_build_mesh(JaxMeshConfig(config.data_parallel, config.model_parallel))
        assert ours.shape == dict(theirs.shape)
        assert len(ours.data_devices) == ours.shape["data"]
    for config in (MeshConfig(model_parallel=3), MeshConfig(data_parallel=5, model_parallel=2)):
        with pytest.raises(ValueError):
            build_mesh(config, devices=devices)
        with pytest.raises(ValueError):
            jax_build_mesh(JaxMeshConfig(config.data_parallel, config.model_parallel))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh()  # no card and no devices: never a silent CPU mesh


def test_train_step_mode_validated():
    for mode in ("auto", "shard_map", "gspmd"):
        assert TrainConfig({"train_step_mode": mode}).train_step_mode == mode
    with pytest.raises(ValueError, match="train_step_mode"):
        TrainConfig({"train_step_mode": "shardmap"})


@pytest.mark.parametrize("dp, tp", [(4, 2), (2, 4)])
def test_tp_shards_equal_jax_addressable_shards(dp, tp):
    params = jax_init_params(TINY, jax.random.key(3))
    mesh = jax_build_mesh(JaxMeshConfig(dp, tp))
    placed = jax.device_put(params, param_shardings(mesh, TINY))
    full = params_from_numpy(jax.tree.map(np.asarray, params))
    cfg = TowerConfig.from_dict(TINY.to_dict())
    ours = [shard_params(full, cfg, tp, m) for m in range(tp)]
    where = {dev: divmod(i, tp) for i, dev in enumerate(mesh.devices.flat)}
    for group, leaves in placed.items():
        for name, arr in leaves.items():
            for sh in arr.addressable_shards:
                _, m = where[sh.device]
                np.testing.assert_array_equal(
                    ours[m][group][name].numpy(), np.asarray(sh.data), err_msg=f"{group}/{name}"
                )
    back = gather_params(ours)
    for group, leaves in full.items():
        for name, t in leaves.items():
            assert torch.equal(back[group][name], t), f"{group}/{name}"


def test_tp_must_divide():
    cfg = TowerConfig.from_dict(TINY.to_dict())
    with pytest.raises(ValueError, match="intermediate_size"):
        validate_tp(dataclasses.replace(cfg, intermediate_size=100), 8)
    with pytest.raises(ValueError, match="num_heads"):
        validate_tp(cfg, 8)
    validate_tp(cfg, 4)


# ------------------------------------------------------------------ the sharded index


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("case", ["f32", "masked", "bf16", "packed", "short"])
def test_sharded_index_matches_jax(dp, case):
    """N = 203 rows (not a multiple of dp), k = 30 (above the 26-row shards
    at dp=8); "short": N = 13 (at dp=8 the last shard is empty), k = 5."""
    rng = np.random.default_rng(dp)
    n, k = (13, 5) if case == "short" else (203, 30)
    emb, q = _unit(rng, n, 32), _unit(rng, 5, 32)
    mask = (rng.random(n) < 0.5).astype(np.int32) if case == "masked" else None
    kw = {"dtype": "bfloat16"} if case == "bf16" else {}
    if case == "packed":
        kw["extraction"] = "packed"
    ours = ShardedCatalogIndex(emb, mesh=cpu_mesh(dp), **kw)
    theirs = JaxSharded(emb, mesh=jax_build_mesh(JaxMeshConfig(dp, 1)), **kw)
    assert (ours.dp, ours.shard_rows) == (theirs.dp, theirs.shard_rows)
    ps, pi = ours.topk(q, k, candidate_mask=mask)
    js, ji = theirs.topk(q, k, candidate_mask=mask)
    one_s, one_i = ShardedCatalogIndex(emb, device="cpu", **kw).topk(q, k, candidate_mask=mask)
    np.testing.assert_array_equal(pi, one_i)
    if case == "packed":
        # JAX's CPU path has no packed form (its reference is exact): hold
        # the packed merge to the one-device packed index, bitwise, and the
        # quantized scores to JAX's exact ones within one 2^-11 step.
        np.testing.assert_array_equal(ps, one_s)
        np.testing.assert_allclose(ps, js, rtol=2.0**-11, atol=0)
        return
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=SCORE_TOL, rtol=0)


def test_ivf_mesh_build_matches_jax():
    rng = np.random.default_rng(9)
    centers = _unit(rng, 40, 32)
    emb = centers[rng.integers(0, 40, 3001)] + 0.25 * rng.standard_normal((3001, 32))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    kw = dict(nlist=32, nprobe=8, seed=0, kmeans_iters=4, build_chunk=300)
    ours = IVFCatalogIndex(emb, mesh=cpu_mesh(4), **kw)
    theirs = JaxIVF(emb, mesh=jax_build_mesh(JaxMeshConfig(4, 1)), **kw)
    assert ours.device == torch.device("cpu")
    np.testing.assert_array_equal(ours._bucket_ids.numpy(), np.asarray(theirs._bucket_ids))
    np.testing.assert_allclose(
        ours._centroids.numpy(), np.asarray(theirs._centroids), atol=CENTROID_TOL, rtol=0
    )
    q = emb[:16]
    np.testing.assert_array_equal(ours.topk(q, 10)[1], theirs.topk(q, 10)[1])


# ------------------------------------------------------------------ encoder, Recommender


@pytest.fixture(scope="module")
def tiny_tower(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_tower")
    corpus = make_corpus(40)
    return make_tiny_model_dir(tmp, corpus), write_corpus_json(tmp, corpus), corpus


def test_text_encoder_over_a_mesh_equals_one_device(tiny_tower):
    model_dir, _, corpus = tiny_tower
    texts = list(corpus.values())
    one = TextEncoder.load(model_dir, device="cpu")
    sharded = TextEncoder.load(model_dir, mesh=cpu_mesh(3))
    assert sharded.device == torch.device("cpu") and len(sharded.shard_devices) == 3
    want = one.encode(texts, batch_size=16)
    np.testing.assert_allclose(sharded.encode(texts, batch_size=16), want, atol=1e-6, rtol=0)
    got = sharded.encode_device(texts[:2]).numpy()  # fewer rows than shards
    np.testing.assert_allclose(got, want[:2], atol=1e-6, rtol=0)


def test_recommender_over_a_mesh_serves_the_one_device_answers(tiny_tower):
    model_dir, corpus_path, _ = tiny_tower
    one = Recommender(model_dir, corpus_path, use_index=False, device="cpu")
    ours = Recommender(model_dir, corpus_path, use_index=False, device="cpu", mesh=cpu_mesh(2))
    assert ours._fused is None and ours.index.dp == 2
    ivf = Recommender(
        model_dir, corpus_path, use_index=False, device="cpu", mesh=cpu_mesh(2), ann=True,
        ann_nlist=4, ann_nprobe=4,
    )
    for query in ("organic milk", "bread and cheese"):
        want = [p for p, _ in one.recommend(query, top_k=5)]
        assert [p for p, _ in ours.recommend(query, top_k=5)] == want
        assert [p for p, _ in ivf.recommend(query, top_k=5)] == want  # full probe: exact
        filtered = ours.recommend(query, top_k=3, filter_aisles=["a1"])
        assert filtered == one.recommend(query, top_k=3, filter_aisles=["a1"])


# ------------------------------------------------------------------ the build lock


FAKE_BUILD = """
import subprocess, sys
from pathlib import Path
from instacart_next_order_recommendation_tpu_torch.ops import _build

root = Path(sys.argv[1])
_build.CSRC_DIR = root / "csrc"
_build.BUILD_DIR = root / "build"
count = root / "compiles.txt"


def fake_nvcc(src, out, defines=()):
    # A compile that takes a while, and counts itself.
    code = (
        "import sys, time; time.sleep(1.5); "
        f"open({str(count)!r}, 'a').write('x'); open(sys.argv[1], 'w').write('lib')"
    )
    return subprocess.Popen([sys.executable, "-c", code, str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


_build.start_nvcc = fake_nvcc
print(sorted(_build.build(("fake",))))
"""


def test_two_processes_build_a_library_once(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake.cu").write_text("// a source")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(FAKE_BUILD), str(tmp_path)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "['fake']"
    assert (tmp_path / "compiles.txt").read_text() == "x"  # one compile, two loads
    assert len(list((tmp_path / "build").glob("libfake-*.so"))) == 1
