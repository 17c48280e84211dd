"""Write a full-shape all-MiniLM-L6-v2-architecture checkpoint for shape
rehearsals of the port's real-data runbook.

The port's counterpart of ``scripts/make_rehearsal_checkpoint.py``. The
reference recipe warm-starts from ``sentence-transformers/all-MiniLM-L6-v2``,
which offline machines cannot download. This script writes a directory with
exactly that architecture (``config.json``, an HF-BERT-named
``pytorch_model.bin`` written by ``torch.save``, a 30,522-line ``vocab.txt``
and the tokenizer config), with random weights (BERT's init: N(0, 0.02),
LayerNorm ones and zeros). For one seed its tensors and vocab are those of
the JAX script, bit for bit.

It rehearses every shape and code path of the warm start (state-dict
parsing, the kernel transposes, vocab ids, the position table); it does not
rehearse pretrained quality, which needs the real weights.

    python scripts/torch_make_rehearsal_checkpoint.py [--out models/all-MiniLM-L6-v2]
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import json
from pathlib import Path

import numpy as np

# all-MiniLM-L6-v2's config.json (architecture fields only).
MINILM_CONFIG = {
    "architectures": ["BertModel"],
    "attention_probs_dropout_prob": 0.1,
    "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1,
    "hidden_size": 384,
    "initializer_range": 0.02,
    "intermediate_size": 1536,
    "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512,
    "model_type": "bert",
    "num_attention_heads": 12,
    "num_hidden_layers": 6,
    "pad_token_id": 0,
    "type_vocab_size": 2,
    "vocab_size": 30522,
}
VOCAB_TEXTS = 4000  # long-name product texts the vocab's learned pieces come from
LEARNED_VOCAB = 8000


def build_vocab(n: int = 30522, seed: int = 0) -> list[str]:
    """BERT's vocab layout: [PAD], [unused0..98], [UNK]/[CLS]/[SEP]/[MASK] at
    ids 100-103, then WordPiece entries trained on long-name synthetic
    product texts (so a rehearsal tokenizes into real continuation pieces),
    padded to exactly ``n`` with [unusedN]."""
    from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
        _ADJECTIVES,
        _AISLES,
        _DEPARTMENTS,
        _NAME_EXTRAS,
        _NAME_MODIFIERS,
        _NAME_UNITS,
        _NOUNS,
    )
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(VOCAB_TEXTS):
        name = (
            f"{rng.choice(_NAME_MODIFIERS)} {rng.choice(_ADJECTIVES)} "
            f"{rng.choice(_NOUNS)} {rng.choice(_NAME_EXTRAS)}, "
            f"{rng.choice(_NAME_UNITS)}"
        )
        texts.append(
            f"Product: {name}. Aisle: {rng.choice(_AISLES)}. "
            f"Department: {rng.choice(_DEPARTMENTS)}."
        )
    tok = WordPieceTokenizer.train(texts, vocab_size=LEARNED_VOCAB, min_frequency=1)
    learned = [
        t for t, _ in sorted(tok.vocab.items(), key=lambda kv: kv[1])
        if not (t.startswith("[") and t.endswith("]"))
    ]

    vocab = ["[PAD]"]
    vocab += [f"[unused{i}]" for i in range(99)]
    vocab += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += learned
    i = 99
    while len(vocab) < n:
        vocab.append(f"[unused{i}]")
        i += 1
    return vocab[:n]


def build_state_dict(cfg: dict, seed: int = 0) -> dict:
    """The HF BERT state dict of ``cfg`` (Linear weights ``(out, in)``),
    drawn from numpy's generator in the JAX script's order."""
    import torch

    rng = np.random.default_rng(seed)
    h, inter, n_layers, vocab = (
        cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"], cfg["vocab_size"],
    )

    def w(*shape):
        return torch.from_numpy(rng.normal(0.0, cfg["initializer_range"], shape).astype(np.float32))

    def ones(*shape):
        return torch.ones(*shape)

    def zeros(*shape):
        return torch.zeros(*shape)

    sd = {
        "embeddings.word_embeddings.weight": w(vocab, h),
        "embeddings.position_embeddings.weight": w(cfg["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": w(cfg["type_vocab_size"], h),
        "embeddings.LayerNorm.weight": ones(h),
        "embeddings.LayerNorm.bias": zeros(h),
    }
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        sd.update({
            p + "attention.self.query.weight": w(h, h),
            p + "attention.self.query.bias": zeros(h),
            p + "attention.self.key.weight": w(h, h),
            p + "attention.self.key.bias": zeros(h),
            p + "attention.self.value.weight": w(h, h),
            p + "attention.self.value.bias": zeros(h),
            p + "attention.output.dense.weight": w(h, h),
            p + "attention.output.dense.bias": zeros(h),
            p + "attention.output.LayerNorm.weight": ones(h),
            p + "attention.output.LayerNorm.bias": zeros(h),
            p + "intermediate.dense.weight": w(inter, h),
            p + "intermediate.dense.bias": zeros(inter),
            p + "output.dense.weight": w(h, inter),
            p + "output.dense.bias": zeros(h),
            p + "output.LayerNorm.weight": ones(h),
            p + "output.LayerNorm.bias": zeros(h),
        })
    # Real BERT checkpoints ship the pooler; the loader ignores it, so its
    # presence rehearses "extra keys are tolerated".
    sd["pooler.dense.weight"] = w(h, h)
    sd["pooler.dense.bias"] = zeros(h)
    return sd


def write_checkpoint(out: Path, seed: int = 0, config: dict | None = None) -> dict:
    """Write the directory; returns its vocab size and parameter count.
    ``config`` defaults to ``MINILM_CONFIG`` (read when called)."""
    import torch

    cfg = config or MINILM_CONFIG
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(cfg, indent=2))
    vocab = build_vocab(cfg["vocab_size"], seed)
    (out / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (out / "tokenizer_config.json").write_text(
        json.dumps({"do_lower_case": True, "model_max_length": 256})
    )
    sd = build_state_dict(cfg, seed)
    torch.save(sd, out / "pytorch_model.bin")
    (out / "REHEARSAL.md").write_text(
        "Random-weight all-MiniLM-L6-v2-architecture checkpoint written by\n"
        "scripts/torch_make_rehearsal_checkpoint.py for full-shape rehearsals of\n"
        "the real-data runbook. Replace it with the real\n"
        "sentence-transformers/all-MiniLM-L6-v2 download for quality runs.\n"
    )
    return {"vocab": len(vocab), "params": sum(int(np.prod(t.shape)) for t in sd.values())}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("models/all-MiniLM-L6-v2"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    info = write_checkpoint(args.out, args.seed)
    print(f"wrote {args.out} (vocab {info['vocab']}, {info['params'] / 1e6:.1f}M params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
