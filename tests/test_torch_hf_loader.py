"""The port's Hugging Face loader against the JAX package's and against
``transformers.BertModel``: ``load_hf_tower`` on the same files (both weight
formats, all three module prefixes), the port's own safetensors reader
against the ``safetensors`` package, the tower on an HF directory against
BertModel with mean-pool and L2 norm, ``load_tower``'s fallback and error,
and the directories the trainer, ``TextEncoder`` and ``Recommender`` take.
No weights are downloaded: every directory is written here from a seeded
``BertModel``."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from transformers import BertConfig, BertModel

from instacart_next_order_recommendation_tpu.models.hf_loader import (
    load_hf_tower as jax_load_hf_tower,
)
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower, save_tower
from instacart_next_order_recommendation_tpu_torch.models.encoder import encode
from instacart_next_order_recommendation_tpu_torch.models.hf_loader import (
    load_hf_tower,
    read_safetensors,
)
from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer
from instacart_next_order_recommendation_tpu_torch.train import trainer as trainer_mod
from instacart_next_order_recommendation_tpu_torch.train.trainer import TrainConfig

from tests.helpers import make_corpus

PREFIXES = ["", "bert.", "0.auto_model."]


def bert_config(vocab_size: int = 100, **kw) -> BertConfig:
    return BertConfig(
        vocab_size=vocab_size,
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        **kw,
    )


def write_hf_dir(path, model: BertModel, prefix: str = "", fmt: str = "bin", tok=None):
    """An HF checkpoint directory: config.json, the weights under ``prefix``
    as ``pytorch_model.bin`` or ``model.safetensors``, and the vocab."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(model.config.to_json_string())
    sd = {prefix + k: v.detach().contiguous() for k, v in model.state_dict().items()}
    if fmt == "bin":
        torch.save(sd, path / "pytorch_model.bin")
    else:
        safetensors.numpy.save_file(
            {k: v.numpy() for k, v in sd.items()}, path / "model.safetensors",
            metadata={"format": "pt"},
        )
    if tok is not None:
        tok.save(path)
    return path


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer.train(make_corpus(40).values(), vocab_size=600, min_frequency=1)


def seeded_bert(vocab_size: int, seed: int = 0) -> BertModel:
    torch.manual_seed(seed)
    return BertModel(bert_config(vocab_size)).eval()


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("prefix", PREFIXES, ids=["bare", "bert", "auto_model"])
def test_load_hf_tower_equals_jax_bitwise(tmp_path, tok, fmt, prefix):
    model_dir = write_hf_dir(tmp_path / "hf", seeded_bert(tok.vocab_size), prefix, fmt, tok)
    params, cfg, ptok = load_hf_tower(model_dir)
    j_params, j_cfg, j_tok = jax_load_hf_tower(model_dir)
    assert cfg.to_dict() == j_cfg.to_dict()
    assert ptok.vocab == j_tok.vocab and ptok.lowercase == j_tok.lowercase
    theirs = jax.tree.map(np.asarray, j_params)
    assert params.keys() == theirs.keys()
    for group in params:
        assert params[group].keys() == theirs[group].keys()
        for name, t in params[group].items():
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), theirs[group][name]), (group, name)
    assert params["layers"]["ffn_w1"].shape == (2, 32, 64)  # (in, out), stacked


def test_read_safetensors_matches_the_package(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "f64": rng.standard_normal((3, 4)),
        "f32": rng.standard_normal((5,)).astype(np.float32),
        "f16": rng.standard_normal((2, 3, 2)).astype(np.float16),
        "i64": rng.integers(-9, 9, (4,)),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "i16": rng.integers(-9, 9, (3,)).astype(np.int16),
        "i8": rng.integers(-9, 9, (3,)).astype(np.int8),
        "u8": rng.integers(0, 9, (3,)).astype(np.uint8),
        "u16": rng.integers(0, 9, (3,)).astype(np.uint16),
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "scalar": np.asarray(1.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    path = tmp_path / "t.safetensors"
    safetensors.numpy.save_file(arrays, path, metadata={"format": "np"})
    ours, theirs = read_safetensors(path), safetensors.numpy.load_file(path)
    assert ours.keys() == theirs.keys() == arrays.keys()
    for name, want in theirs.items():
        assert ours[name].dtype == want.dtype and ours[name].shape == want.shape, name
        assert np.array_equal(ours[name], want), name


def test_read_safetensors_refuses_bf16_clearly(tmp_path):
    path = tmp_path / "bf16.safetensors"
    safetensors.torch.save_file({"w": torch.ones(2, 2, dtype=torch.bfloat16)}, path)
    with pytest.raises(ValueError, match="BF16, which has no numpy dtype"):
        read_safetensors(path)


def test_tower_on_an_hf_dir_matches_bert_model(tmp_path):
    """The port's counterpart of ``test_parity_with_hf_bert``: BertModel,
    sentence-transformers' mean-pool, then L2 norm, at f32."""
    hf_model = seeded_bert(100)
    model_dir = write_hf_dir(tmp_path / "hf", hf_model)
    params, cfg, _ = load_tower(model_dir)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 100, size=(3, 12)).astype(np.int64)
    mask = (np.arange(12)[None, :] < np.array([12, 7, 4])[:, None]).astype(np.int64)
    with torch.no_grad():
        hidden = hf_model(
            input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)
        ).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    pooled = (hidden * m).sum(1) / np.maximum(m.sum(1), 1e-9)
    expected = pooled / np.maximum(np.linalg.norm(pooled, axis=1, keepdims=True), 1e-12)
    ours = encode(
        params, torch.from_numpy(ids).to(torch.int32), torch.from_numpy(mask).to(torch.int32), cfg
    )
    np.testing.assert_allclose(ours.numpy(), expected, atol=2e-5)


def test_load_tower_falls_back_to_hf_and_names_both_files(tmp_path, tok):
    model_dir = write_hf_dir(tmp_path / "hf", seeded_bert(tok.vocab_size), "0.auto_model.",
                             "safetensors", tok)
    params, cfg, ptok = load_tower(model_dir)
    want, want_cfg, _ = load_hf_tower(model_dir)
    assert cfg == want_cfg and ptok.vocab == tok.vocab
    assert all(torch.equal(params["layers"][n], t) for n, t in want["layers"].items())
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No model_config.json or config.json"):
        load_tower(tmp_path / "empty")
    (tmp_path / "no_weights").mkdir()
    (tmp_path / "no_weights" / "config.json").write_text(bert_config().to_json_string())
    with pytest.raises(FileNotFoundError, match="No model.safetensors or pytorch_model.bin"):
        load_tower(tmp_path / "no_weights")


def test_warm_start_builds_the_model_from_the_hf_weights(tmp_path, tok):
    model_dir = write_hf_dir(tmp_path / "hf", seeded_bert(tok.vocab_size), "bert.", "bin", tok)
    trainer = trainer_mod.TwoTowerTrainer(
        TrainConfig({"model_name": str(model_dir), "max_seq_length": 32,
                     "output_dir": str(tmp_path / "out")}),
        device="cpu",
    )
    params, cfg, ptok = trainer._build_model(None)  # a warm start trains no vocab
    want, want_cfg, _ = load_hf_tower(model_dir)
    assert cfg == dataclasses.replace(want_cfg, max_seq_length=32, remat=False)
    assert ptok.vocab == tok.vocab
    for group in want:
        for name, t in want[group].items():
            assert torch.equal(params[group][name], t), (group, name)


def test_encoder_and_recommender_take_an_hf_dir(tmp_path, tok):
    """An HF directory serves as the same tower saved in the shared format."""
    corpus = make_corpus(40)
    corpus_path = tmp_path / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    hf_dir = write_hf_dir(tmp_path / "hf", seeded_bert(tok.vocab_size, seed=3), "", "bin", tok)
    params, cfg, _ = load_tower(hf_dir)
    save_tower(tmp_path / "msgpack", params, cfg, tok)
    recs = [Recommender(d, corpus_path, use_index=False, device="cpu")
            for d in (hf_dir, tmp_path / "msgpack")]
    assert torch.equal(recs[0].index.catalog, recs[1].index.catalog)
    for q in ("Organic Milk 3", "Cheese and Bread"):
        assert recs[0].recommend(q, top_k=5) == recs[1].recommend(q, top_k=5)
