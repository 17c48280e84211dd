"""The port's tower at head_dim 64 (mpnet-base-class) on the CPU against the
JAX package, on both routes: the unfused layer; ``encode`` through the fused
layer where its kernels take the shape (S % 16 == 0, S <= 256) and through
the unfused one at a length they do not take; one training step on either
route, remat, the remat policy, the ``mpnet-base`` preset through
``TwoTowerTrainer`` (its ``final/`` read by JAX), mpnet-width checkpoints,
and the packed top-k extraction through ``Recommender``."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu import ops as jax_ops_pkg
from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    encode as jax_encode,
    init_params as jax_init_params,
    load_tower as jax_load_tower,
    save_tower as jax_save_tower,
)
from instacart_next_order_recommendation_tpu.models.encoder import (
    MPNET_BASE_CLASS as JAX_MPNET_BASE_CLASS,
    _encoder_layer as jax_encoder_layer,
)
from instacart_next_order_recommendation_tpu.ops import fused_layer as jax_fused_layer
from instacart_next_order_recommendation_tpu.ops.mnrl import mnrl_loss as jax_mnrl_loss
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu.train import TwoTowerTrainer as JaxTwoTowerTrainer
from instacart_next_order_recommendation_tpu_torch.models import MPNET_BASE_CLASS
from instacart_next_order_recommendation_tpu_torch.models import encoder as encoder_mod
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import (
    load_tower,
    params_from_numpy,
    save_tower,
)
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    TowerConfig,
    encode,
)
from instacart_next_order_recommendation_tpu_torch.ops import mnrl_loss
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import prepare_layer
from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
from instacart_next_order_recommendation_tpu_torch.train import trainer as trainer_mod
from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainConfig,
    TrainStep,
    TwoTowerTrainer,
    build_optimizer,
    warmup_cosine_schedule,
)

# head_dim 64, as mpnet-base-class: the fused route at S % 16 == 0 (S <= 256),
# the unfused one at S = 40.
HD64 = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256, max_position=64)
# MiniLM-class (head_dim 32); the unfused route at S = 40 (S % 16 != 0).
HD32 = dict(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=64)


def _jax_params(arch, seed, vocab=120):
    cfg = JaxTowerConfig(vocab_size=vocab, **arch)
    host = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.key(seed)))
    # Non-trivial biases and LayerNorm params, so every term of the layer counts.
    rng = np.random.default_rng(seed)
    for name in ("q_b", "k_b", "v_b", "o_b", "ffn_b1", "ffn_b2", "attn_ln_bias", "ffn_ln_bias"):
        host["layers"][name] = (0.02 * rng.standard_normal(host["layers"][name].shape)).astype(
            np.float32
        )
    return host


def _ids_mask(rng, batch, seq, vocab=120, all_pad_row=False):
    lengths = rng.integers(2, seq + 1, size=batch)
    lengths[0] = seq  # one row fills the bucket
    if all_pad_row:
        lengths[-1] = 0
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.integers(5, vocab, size=(batch, seq)), 0).astype(np.int32)
    return ids, mask


class Routes:
    """Counts the layers each route ran (the CPU has no launch counters)."""

    def __init__(self, monkeypatch):
        self.unfused = 0
        self.fused = 0
        inner = encoder_mod._encoder_layer

        def unfused(*args, **kwargs):
            self.unfused += 1
            return inner(*args, **kwargs)

        def fused(inner_fused):
            def run(*args, **kwargs):
                self.fused += 1
                return inner_fused(*args, **kwargs)

            return run

        monkeypatch.setattr(encoder_mod, "_encoder_layer", unfused)
        monkeypatch.setattr(encoder_mod, "fused_encoder_layer", fused(encoder_mod.fused_encoder_layer))
        monkeypatch.setattr(
            encoder_mod, "fused_encoder_layer_train", fused(encoder_mod.fused_encoder_layer_train)
        )


def test_mpnet_preset_matches_jax():
    assert MPNET_BASE_CLASS.to_dict() == JAX_MPNET_BASE_CLASS.to_dict()
    assert MPNET_BASE_CLASS.head_dim == 64
    assert trainer_mod._PRESETS["mpnet-base"] == MPNET_BASE_CLASS


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_unfused_layer_matches_jax(dtype, atol):
    # bf16: another summation order can flip the rounding of a stored
    # activation, and LayerNorm outputs reach |y| ~ 4, where one bf16 ulp
    # is 2^-6; 3e-2 is two such ulps.
    host = _jax_params(HD64, seed=0)
    cfg = JaxTowerConfig(vocab_size=120, compute_dtype=dtype, hidden_dropout=0.0, **HD64)
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((3, 40, 128))).astype(np.float32)
    _, mask = _ids_mask(rng, 3, 40, all_pad_row=True)
    cdt = jnp.dtype(dtype)
    layer = {k: np.array(v[0]) for k, v in host["layers"].items()}
    ref = jax_encoder_layer(
        jnp.asarray(x, cdt), {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(mask),
        cfg, None,
    )
    tdt = encoder_mod.DTYPES[dtype]
    out = encoder_mod._encoder_layer(
        torch.from_numpy(x).to(tdt),
        prepare_layer({k: torch.from_numpy(v) for k, v in layer.items()}, tdt),
        torch.from_numpy(mask),
        TowerConfig.from_dict(cfg.to_dict()),
    )
    assert out.dtype == tdt and tuple(out.shape) == x.shape
    np.testing.assert_allclose(
        out.to(torch.float32).numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol
    )


@pytest.mark.parametrize("arch,seq", [(HD64, 40), (HD32, 40)])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_encode_takes_the_unfused_route_and_matches_jax(monkeypatch, arch, seq, dtype, atol):
    host = _jax_params(arch, seed=2)
    rng = np.random.default_rng(3)
    ids, mask = _ids_mask(rng, 4, seq, all_pad_row=True)
    jcfg = JaxTowerConfig(vocab_size=120, compute_dtype=dtype, **arch)
    ref = jax_encode(jax.tree.map(jnp.asarray, host), jnp.asarray(ids), jnp.asarray(mask), jcfg)
    routes = Routes(monkeypatch)
    out = encode(
        params_from_numpy(host), torch.from_numpy(ids), torch.from_numpy(mask),
        TowerConfig.from_dict(jcfg.to_dict()),
    )
    assert (routes.unfused, routes.fused) == (arch["num_layers"], 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("seq", [32, 48])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_encode_takes_the_fused_route_at_head_dim_64_and_matches_jax(
    monkeypatch, seq, dtype, atol
):
    # The tolerances of the unfused route: f32 sums in another order; in
    # bf16 a flipped rounding of a stored activation, two bf16 ulps at |y| ~ 4.
    host = _jax_params(HD64, seed=2)
    rng = np.random.default_rng(3)
    ids, mask = _ids_mask(rng, 4, seq, all_pad_row=True)
    jcfg = JaxTowerConfig(vocab_size=120, compute_dtype=dtype, **HD64)
    ref = jax_encode(jax.tree.map(jnp.asarray, host), jnp.asarray(ids), jnp.asarray(mask), jcfg)
    routes = Routes(monkeypatch)
    out = encode(
        params_from_numpy(host), torch.from_numpy(ids), torch.from_numpy(mask),
        TowerConfig.from_dict(jcfg.to_dict()),
    )
    assert (routes.unfused, routes.fused) == (0, HD64["num_layers"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def test_both_routes_draw_the_same_dropout_masks(monkeypatch):
    """A tower keeps its draws when its route changes: the unfused route
    draws m1 then m2 of each layer, [B, S, H], as the fused route does."""
    host = _jax_params(HD32, seed=4)
    cfg = TowerConfig(vocab_size=120, compute_dtype="float32", **HD32)
    rng = np.random.default_rng(5)
    ids, mask = (torch.from_numpy(a) for a in _ids_mask(rng, 3, 32))
    params = params_from_numpy(host)
    runs = {}
    for route in ("fused", "unfused"):
        if route == "unfused":
            monkeypatch.setattr(encoder_mod, "supports", lambda *a: False)
        gen = torch.Generator().manual_seed(11)
        out = encode(params, ids, mask, cfg, generator=gen)
        runs[route] = (out, gen.get_state())
    assert torch.equal(runs["fused"][1], runs["unfused"][1])
    # The fused route multiplies by the mask's 1/keep; the unfused divides
    # by keep, as JAX's _dropout: an f32 rounding apart.
    np.testing.assert_allclose(runs["fused"][0].numpy(), runs["unfused"][0].numpy(), atol=1e-5)


def _batch(rng, batch=8, seq=32):
    out = []
    for _ in range(2):
        ids, mask = _ids_mask(rng, batch, seq)
        out += [ids, mask]
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _trainable(host):
    return jax.tree.map(lambda t: t.requires_grad_(True), params_from_numpy(host))


def test_train_step_at_head_dim_64_matches_jax(monkeypatch):
    """One step at dropout 0, f32, on each route (S = 32 fused, S = 40
    unfused): loss and every gradient against ``jax.value_and_grad`` of JAX
    ``encode`` + ``mnrl_loss``."""
    host = _jax_params(HD64, seed=6)
    jcfg = JaxTowerConfig(vocab_size=120, compute_dtype="float32", hidden_dropout=0.0, **HD64)

    def loss_fn(p, a_ids, a_mask, p_ids, p_mask):
        return jax_mnrl_loss(
            jax_encode(p, a_ids, a_mask, jcfg), jax_encode(p, p_ids, p_mask, jcfg), scale=30.0
        )

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    layers = 2 * HD64["num_layers"]  # two towers a step
    for seq, (unfused, fused) in ((32, (0, layers)), (40, (layers, 0))):
        batch = _batch(np.random.default_rng(7), seq=seq)
        loss_ref, grads_ref = value_and_grad(
            jax.tree.map(jnp.asarray, host), *(jnp.asarray(b) for b in batch)
        )
        routes = Routes(monkeypatch)
        params = _trainable(host)
        step = TrainStep(
            params, TowerConfig.from_dict(jcfg.to_dict()), build_optimizer(params, 0.0),
            warmup_cosine_schedule(1e-3, 10), loss_scale=30.0, accum=2,
            device=torch.device("cpu"),
        )
        loss = step([torch.from_numpy(b) for b in batch], seed=0)  # accumulates only
        assert (routes.unfused, routes.fused) == (unfused, fused), seq
        np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
        ours, theirs = _flat(params), _flat(jax.tree.map(np.asarray, grads_ref))
        assert ours.keys() == theirs.keys()
        for name, t in ours.items():
            # The backward holds loss / accum; f32 sums in another order.
            np.testing.assert_allclose(
                2 * t.grad.numpy(), theirs[name], atol=2e-6, rtol=2e-4, err_msg=f"{name} S={seq}"
            )
        monkeypatch.undo()


def test_remat_gives_identical_loss_and_gradients(monkeypatch):
    # At S = 40, which the fused kernels do not take: remat checkpoints the
    # unfused layers.
    host = _jax_params(HD64, seed=8)
    batch = [torch.from_numpy(b) for b in _batch(np.random.default_rng(9), seq=40)]
    results = {}
    for remat in (False, True):
        routes = Routes(monkeypatch)
        cfg = TowerConfig(vocab_size=120, compute_dtype="float32", remat=remat, **HD64)
        params = _trainable(host)
        gen = torch.Generator().manual_seed(3)  # dropout 0.1, the same masks
        qa = encode(params, batch[0], batch[1], cfg, generator=gen)
        qp = encode(params, batch[2], batch[3], cfg, generator=gen)
        loss = mnrl_loss(qa, qp, scale=30.0)
        loss.backward()
        # With remat every layer runs again in the backward.
        assert routes.unfused == 2 * HD64["num_layers"] * (2 if remat else 1)
        results[remat] = (loss.detach(), {n: t.grad for n, t in _flat(params).items()})
        monkeypatch.undo()
    assert torch.equal(results[False][0], results[True][0])
    for name, g in results[False][1].items():
        assert torch.equal(g, results[True][1][name]), name


def test_resolve_remat_matches_the_jax_policy(monkeypatch):
    def port(batch, shape, seq, remat=None):
        stub = SimpleNamespace(cfg=SimpleNamespace(remat=remat, train_batch_size=batch))
        return TwoTowerTrainer._resolve_remat(stub, *shape, seq)

    def jax_policy(batch, shape, seq, remat=None):
        stub = SimpleNamespace(cfg=SimpleNamespace(remat=remat, train_batch_size=batch))
        return JaxTwoTowerTrainer._resolve_remat(stub, *shape, seq)

    minilm, mpnet, odd = (384, 12, 1536), (768, 12, 3072), (300, 12, 1200)
    # The JAX policy as it reads on the chip: its kernels on.
    monkeypatch.setenv("ITOR_FORCE_PALLAS", "1")
    jax_ops_pkg.use_pallas.cache_clear()
    try:
        for case in [
            (512, minilm, 256, True), (512, minilm, 256, False), (64, mpnet, 256, None),
            (255, mpnet, 128, None), (256, minilm, 128, None), (512, minilm, 256, None),
            (512, odd, 128, None), (512, mpnet, 200, None),
            (256, mpnet, 256, False),
        ]:
            assert port(*case) == jax_policy(*case), case
        # mpnet-base-class at B >= 256 and S <= 512: JAX's backward kernel
        # does not fit a v5e's VMEM (bwd_supports), so it keeps remat on;
        # the port's K5 takes the tower (at S = 512 too, since its kernels
        # take JAX's whole envelope) and keeps no more than four residuals.
        for case in [(256, mpnet, 256, None), (512, mpnet, 128, None), (256, mpnet, 512, None)]:
            assert not jax_fused_layer.bwd_supports(mpnet[0], mpnet[2], case[2])
            assert jax_policy(*case) is True and port(*case) is False, case
        # JAX tests its gate at seq rounded down to a multiple of 16, so at
        # max_seq_length 200 it leaves remat off, though a batch that fills
        # 200 takes its unfused layer (its own encode gate says no at 200).
        assert jax_policy(512, minilm, 200) is False
        assert not jax_fused_layer.supports(384, 12, 200)
        assert port(512, minilm, 200) is True
    finally:
        monkeypatch.delenv("ITOR_FORCE_PALLAS", raising=False)
        jax_ops_pkg.use_pallas.cache_clear()


# ------------------------------------------------------- the trainer, end to end


def _pairs():
    """(anchors, positives, eval_pairs, queries, corpus, relevant) in memory."""
    rng = np.random.default_rng(12)
    nouns = ["Milk", "Bread", "Banana", "Yogurt", "Coffee", "Granola", "Pasta", "Cheese"]
    aisles = ["dairy", "bakery", "fruit", "breakfast"]
    corpus = {
        str(i + 1): f"Product: {nouns[i % 8]} {i}. Aisle: {aisles[i % 4]}. Department: d{i % 3}."
        for i in range(48)
    }
    names = [t.split("Product: ")[1].split(".")[0] for t in corpus.values()]
    anchors, positives, queries, relevant = [], [], {}, {}
    for u in range(40):
        basket = rng.choice(48, size=4, replace=False)
        context = "[+3d w1h9] " + ", ".join(names[j] for j in rng.choice(48, 5, replace=False))
        if u < 8:
            queries[f"q{u}"] = context
            relevant[f"q{u}"] = {str(j + 1) for j in basket}
            continue
        for j in basket:
            anchors.append(context + ". Next: w2h10")
            positives.append(corpus[str(j + 1)])
    return anchors, positives, None, queries, corpus, relevant


def test_mpnet_base_trainer_final_read_by_jax(monkeypatch, tmp_path):
    tiny = dataclasses.replace(MPNET_BASE_CLASS, compute_dtype="float32", **HD64)
    monkeypatch.setitem(trainer_mod._PRESETS, "mpnet-base", tiny)
    routes = Routes(monkeypatch)
    cfg = TrainConfig({
        "output_dir": str(tmp_path / "out"), "model_name": "mpnet-base", "max_seq_length": 64,
        "epochs": 2, "train_batch_size": 16, "eval_batch_size": 16, "learning_rate": 2e-3,
        "vocab_size": 400, "logging_steps": 2,
    })
    result = TwoTowerTrainer(cfg, device="cpu").train(data=_pairs())
    # Batches pad to a multiple of 16 within max_seq_length 64: the fused route.
    assert routes.fused > 0 and routes.unfused == 0
    hist = result["history"]
    assert len(hist) == 2 and all(0.0 <= h["ndcg_at_10"] <= 1.0 for h in hist)

    params, tower_cfg, tok = load_tower(tmp_path / "out" / "final")
    j_params, j_cfg, j_tok = jax_load_tower(tmp_path / "out" / "final")
    assert tower_cfg.head_dim == 64 and tower_cfg.remat is False  # batch 16 < 256
    texts = ["[+7d w4h14] Milk 3, Bread 9.", "Product: Banana 2. Aisle: fruit. Department: d2."]
    ids, mask = tok.encode_batch(texts, max_seq_length=64)
    j_ids, _ = j_tok.encode_batch(texts, max_seq_length=64)
    np.testing.assert_array_equal(ids, j_ids)
    ours = encode(params, torch.from_numpy(ids), torch.from_numpy(mask), tower_cfg).numpy()
    theirs = np.asarray(jax_encode(j_params, jnp.asarray(ids), jnp.asarray(mask), j_cfg))
    np.testing.assert_allclose(ours, theirs, atol=2e-5)


def test_mpnet_width_checkpoint_carries_across(tmp_path):
    """H=768, 12 heads, I=3072 (one layer): a JAX tower loads in the port and
    encodes the same; the port's save loads in JAX bit for bit."""
    arch = dict(
        hidden_size=768, num_layers=1, num_heads=12, intermediate_size=3072, max_position=64,
        compute_dtype="float32",
    )
    cfg = JaxTowerConfig(vocab_size=150, **arch)
    texts = ["Product: Organic Milk 1. Aisle: milk. Department: dairy."] * 2
    tok = JaxWordPieceTokenizer.train(texts, vocab_size=150, min_frequency=1)
    jax_params = jax_init_params(cfg, jax.random.key(13))
    jax_save_tower(tmp_path / "jax", jax_params, cfg, tok)
    params, port_cfg, _ = load_tower(tmp_path / "jax")
    rng = np.random.default_rng(14)
    ids, mask = _ids_mask(rng, 3, 40, vocab=150)
    ours = encode(params, torch.from_numpy(ids), torch.from_numpy(mask), port_cfg).numpy()
    theirs = np.asarray(jax_encode(jax_params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    np.testing.assert_allclose(ours, theirs, atol=2e-5)
    save_tower(tmp_path / "port", params, port_cfg)
    back, back_cfg, _ = jax_load_tower(tmp_path / "port")
    assert back_cfg.to_dict() == cfg.to_dict()
    for name, leaf in _flat(jax.tree.map(np.asarray, back)).items():
        assert leaf.tobytes() == _flat(jax.tree.map(np.asarray, jax_params))[name].tobytes(), name


# ------------------------------------------------------ packed extraction, served


@pytest.fixture(scope="module")
def recommenders(tmp_path_factory):
    base = tmp_path_factory.mktemp("packed")
    corpus = _pairs()[4]
    corpus_path = base / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    tok = JaxWordPieceTokenizer.train(corpus.values(), vocab_size=400, min_frequency=1)
    cfg = JaxTowerConfig(vocab_size=tok.vocab_size, compute_dtype="float32", **HD64)
    jax_save_tower(base / "model", jax_init_params(cfg, jax.random.key(15)), cfg, tok)
    exact = Recommender(base / "model", corpus_path, use_index=False, device="cpu")
    packed = Recommender(
        base / "model", corpus_path, use_index=False, device="cpu", topk_extraction="packed"
    )
    return exact, packed


def test_packed_recommender_matches_exact_up_to_quantization(recommenders):
    exact, packed = recommenders
    assert packed.index.packed and packed._fused.packed and not exact.index.packed
    row = {pid: i for i, pid in enumerate(exact.product_ids)}
    for query in ("[+7d w4h14] Milk 3, Bread 9.", "Coffee 4, Granola 5", "Yogurt"):
        a = exact.recommend(query, top_k=10)
        b = packed.recommend(query, top_k=10)
        assert len(a) == len(b) == 10
        scores = exact.index.catalog.numpy() @ exact.encoder.encode([query])[0]
        for (pa, sa), (pb, sb) in zip(a, b):
            # A swap is a tie within the 20-bit quantization; scores quantized.
            assert abs(scores[row[pa]] - scores[row[pb]]) <= 2.0**-10 * abs(sa)
            assert abs(sb - sa) <= 2.0**-10 * abs(sa)
        filtered = packed.recommend(query, top_k=5, filter_aisles=["dairy"])
        assert all("Aisle: dairy." in packed.pid_to_text[p] for p, _ in filtered)


def test_topk_extraction_from_the_environment(recommenders, monkeypatch):
    exact, _ = recommenders
    monkeypatch.setenv("ITOR_TOPK_EXTRACTION", "packed")
    rec = Recommender(exact.model_dir, exact.corpus_path, use_index=False, device="cpu")
    assert rec.index.packed and rec._fused.packed
    monkeypatch.setenv("ITOR_TOPK_EXTRACTION", "fast")
    with pytest.raises(ValueError, match="extraction"):
        Recommender(exact.model_dir, exact.corpus_path, use_index=False, device="cpu")
