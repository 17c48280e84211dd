"""The program under test, built from the benchmark's inputs.

The only module besides the drivers that imports the port: it turns a
configuration file into the port's ``TowerConfig``, and hands the port the
vocab and the weights the benchmark made.
"""

from __future__ import annotations

PORT = "instacart_next_order_recommendation_tpu_torch"


def tower_config(cfg: dict, max_seq_length: int, dropout: float | None = None):
    from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig

    return TowerConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=cfg["hidden_dropout_prob"] if dropout is None else dropout,
        max_seq_length=max_seq_length,
        compute_dtype=cfg["compute_dtype"],
        remat=False,
    )


def tokenizer(vocab: dict[str, int]):
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer(dict(vocab))
