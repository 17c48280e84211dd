"""Tower checkpoints move between the JAX package and the port unchanged."""

import jax
import numpy as np
import torch

from instacart_next_order_recommendation_tpu.models.checkpoint import (
    load_tower as jax_load_tower,
    save_tower as jax_save_tower,
)
from instacart_next_order_recommendation_tpu.models.encoder import (
    TowerConfig as JaxTowerConfig,
    init_params as jax_init_params,
)
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import (
    load_tower,
    params_from_numpy,
    params_to_numpy,
    save_tower,
)
from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig, init_params
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

SMALL = dict(
    vocab_size=120, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    max_position=64, compute_dtype="float32",
)
TEXTS = ["Product: Organic Milk 1. Aisle: milk. Department: dairy."] * 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_bit_identical(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype and fa[name].shape == fb[name].shape, name
        assert fa[name].tobytes() == fb[name].tobytes(), name


def test_jax_save_port_load(tmp_path):
    cfg = JaxTowerConfig(**SMALL)
    params = jax_init_params(cfg, jax.random.key(3))
    tok = JaxWordPieceTokenizer.train(TEXTS, vocab_size=100, min_frequency=1)
    jax_save_tower(tmp_path, params, cfg, tok)
    ours, ours_cfg, ours_tok = load_tower(tmp_path)
    _assert_bit_identical(ours, jax.tree.map(np.asarray, params))
    assert ours_cfg.to_dict() == cfg.to_dict()
    assert ours_tok.vocab == tok.vocab


def test_port_save_jax_load(tmp_path):
    cfg = TowerConfig(**SMALL)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    tok = WordPieceTokenizer.train(TEXTS, vocab_size=100, min_frequency=1)
    save_tower(tmp_path, params, cfg, tok)
    theirs, theirs_cfg, theirs_tok = jax_load_tower(tmp_path)
    _assert_bit_identical(params, jax.tree.map(np.asarray, theirs))
    assert theirs_cfg.to_dict() == cfg.to_dict()
    assert theirs_tok.vocab == tok.vocab


def test_numpy_round_trip():
    params = init_params(TowerConfig(**SMALL), torch.Generator().manual_seed(4))
    back = params_from_numpy(params_to_numpy(params))
    _assert_bit_identical(params, back)
    assert back["layers"]["q_w"].device.type == "cpu"
