"""The port's tower and tokenizer against the JAX package's, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.models.encoder import (
    MINILM_L6 as JAX_MINILM_L6,
    TowerConfig as JaxTowerConfig,
    encode as jax_encode,
    init_params as jax_init_params,
)
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_from_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    MINILM_L6,
    TowerConfig,
    encode,
    init_params,
    prepare_layers,
)
from instacart_next_order_recommendation_tpu_torch.tokenizer import (
    LENGTH_BUCKETS,
    WordPieceTokenizer,
    bucket_length,
)

SMALL = dict(
    vocab_size=97, hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
    max_position=64,
)


@pytest.fixture(scope="module")
def jax_params_np():
    cfg = JaxTowerConfig(**SMALL)
    params = jax_init_params(cfg, jax.random.key(0))
    # Non-trivial biases and LayerNorm params, so every term of the layer counts.
    rng = np.random.default_rng(0)
    host = jax.tree.map(np.asarray, params)
    for name in ("q_b", "k_b", "v_b", "o_b", "ffn_b1", "ffn_b2", "attn_ln_bias", "ffn_ln_bias"):
        host["layers"][name] = (0.02 * rng.standard_normal(host["layers"][name].shape)).astype(
            np.float32
        )
    return host


def _ids(rng, batch, seq, vocab, pad_id=0):
    ids = rng.integers(5, vocab, size=(batch, seq)).astype(np.int32)
    lengths = rng.integers(2, seq + 1, size=batch)
    ids[np.arange(seq)[None, :] >= lengths[:, None]] = pad_id
    return ids


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_encode_matches_jax(jax_params_np, dtype, atol):
    rng = np.random.default_rng(1)
    ids = _ids(rng, 3, 32, SMALL["vocab_size"])
    mask = (ids != 0).astype(np.int32)
    jcfg = JaxTowerConfig(**SMALL, compute_dtype=dtype)
    ref = np.asarray(
        jax_encode(jax.tree.map(jnp.asarray, jax_params_np), jnp.asarray(ids), jnp.asarray(mask), jcfg)
    )
    cfg = TowerConfig(**SMALL, compute_dtype=dtype)
    params = params_from_numpy(jax_params_np)
    out = encode(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, SMALL["hidden_size"])
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)
    # Prepared layers give the same forward as the raw stacked params.
    again = encode(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                   layers=prepare_layers(params, cfg))
    assert torch.equal(out, again)


def test_sequence_past_position_table_raises(jax_params_np):
    cfg = TowerConfig(**SMALL, compute_dtype="float32")
    params = params_from_numpy(jax_params_np)
    ids = torch.ones((1, SMALL["max_position"] + 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="position table"):
        encode(params, ids, torch.ones_like(ids), cfg)


def test_config_and_init_layout_match_jax():
    assert MINILM_L6.to_dict() == JAX_MINILM_L6.to_dict()
    assert TowerConfig.from_dict({**MINILM_L6.to_dict(), "unknown": 1}) == MINILM_L6
    cfg = TowerConfig(**SMALL)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jax_init_params(JaxTowerConfig(**SMALL), jax.random.key(0))
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)
    }
    ours = {f"{g}/{n}": t for g, group in params.items() for n, t in group.items()}
    assert set(ours) == set(flat)
    for name, t in ours.items():
        assert tuple(t.shape) == flat[name].shape and t.dtype == torch.float32
    w = params["layers"]["ffn_w1"]
    assert w.abs().max().item() <= 0.04 + 1e-7  # truncated at two standard deviations
    assert abs(w.std().item() - 0.02 * 0.8796) < 1e-3  # std of N(0,1) cut at +-2


def test_tokenizer_matches_jax():
    texts = [
        "Product: Organic Milk 12. Aisle: milk. Department: dairy eggs.",
        "Product: Crunchy Granola 7. Aisle: cereal. Department: breakfast.",
        "[+3d w1h9] Banana, Greek Yogurt, Honey; [+7d w4h14] Café Crème.",
        "",
    ]
    ours = WordPieceTokenizer.train(texts * 3, vocab_size=300, min_frequency=1)
    theirs = JaxWordPieceTokenizer.train(texts * 3, vocab_size=300, min_frequency=1)
    assert ours.vocab == theirs.vocab
    for kw in ({}, {"pad_batch_to": 7}, {"max_seq_length": 8}):
        a = ours.encode_batch(texts, **kw)
        b = theirs.encode_batch(texts, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert LENGTH_BUCKETS[0] == 16 and bucket_length(17) == 32 and bucket_length(300) == 256
    assert dataclasses.asdict(MINILM_L6)["compute_dtype"] == "bfloat16"
