"""Load Hugging Face BERT/MiniLM checkpoints into the port's param tree.

The port's copy of the JAX package's ``models/hf_loader.py``: a directory
with ``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``
(e.g. ``sentence-transformers/all-MiniLM-L6-v2``) loads as
``(params, TowerConfig, tokenizer)``, the same triple ``load_tower``
returns. Weights may sit under the module prefixes ``""``, ``"bert."`` or
``"0.auto_model."`` (sentence-transformers wrappers). A torch Linear stores
``weight`` as (out, in); the tower's layout is (in, out), so every Linear
weight is transposed.

``model.safetensors`` is read by :func:`read_safetensors`, a reader of the
format's own (no ``safetensors`` package needed).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.models.encoder import Params, TowerConfig
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

PREFIXES = ("", "bert.", "0.auto_model.")

# The safetensors dtypes that have a numpy dtype (those that
# ``safetensors.numpy.load_file`` reads); the data is little-endian.
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "U64": "<u8", "I32": "<i4", "U32": "<u4",
    "I16": "<i2", "U16": "<u2", "I8": "i1", "U8": "u1",
    "BOOL": "?", "C64": "<c8",
}

# ours -> (HF name inside encoder.layer.{i}, transposed)
LAYER_MAP = {
    "q_w": ("attention.self.query.weight", True),
    "q_b": ("attention.self.query.bias", False),
    "k_w": ("attention.self.key.weight", True),
    "k_b": ("attention.self.key.bias", False),
    "v_w": ("attention.self.value.weight", True),
    "v_b": ("attention.self.value.bias", False),
    "o_w": ("attention.output.dense.weight", True),
    "o_b": ("attention.output.dense.bias", False),
    "attn_ln_scale": ("attention.output.LayerNorm.weight", False),
    "attn_ln_bias": ("attention.output.LayerNorm.bias", False),
    "ffn_w1": ("intermediate.dense.weight", True),
    "ffn_b1": ("intermediate.dense.bias", False),
    "ffn_w2": ("output.dense.weight", True),
    "ffn_b2": ("output.dense.bias", False),
    "ffn_ln_scale": ("output.LayerNorm.weight", False),
    "ffn_ln_bias": ("output.LayerNorm.bias", False),
}

EMBEDDING_MAP = {
    "word": "embeddings.word_embeddings.weight",
    "position": "embeddings.position_embeddings.weight",
    "token_type": "embeddings.token_type_embeddings.weight",
    "ln_scale": "embeddings.LayerNorm.weight",
    "ln_bias": "embeddings.LayerNorm.bias",
}


def read_safetensors(path: Path | str) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file as name -> numpy array: an 8-byte
    little-endian header length, the JSON header (each tensor's ``dtype``,
    ``shape`` and ``data_offsets`` into the data that follows; an optional
    ``__metadata__``), then the data."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + n])
    data = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}, which has no numpy "
                f"dtype; the loader reads {sorted(_SAFETENSORS_DTYPES)}"
            )
        lo, hi = info["data_offsets"]
        out[name] = np.frombuffer(data[lo:hi], dtype=dtype).reshape(info["shape"])
    return out


def _load_state_dict(model_dir: Path) -> dict[str, np.ndarray]:
    st_path = model_dir / "model.safetensors"
    if st_path.exists():
        return read_safetensors(st_path)
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"No model.safetensors or pytorch_model.bin in {model_dir}")


def load_hf_tower(model_dir: Path | str) -> tuple[Params, TowerConfig, WordPieceTokenizer | None]:
    """Load an HF BERT-encoder checkpoint directory: f32 CPU tensors in the
    tower's stacked-layer layout, its config, and its vocab if present."""
    model_dir = Path(model_dir)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    config = TowerConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        intermediate_size=hf_cfg["intermediate_size"],
        max_position=hf_cfg["max_position_embeddings"],
        type_vocab_size=hf_cfg.get("type_vocab_size", 2),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        hidden_dropout=hf_cfg.get("hidden_dropout_prob", 0.1),
    )

    sd = _load_state_dict(model_dir)
    prefix = next((p for p in PREFIXES if f"{p}{EMBEDDING_MAP['word']}" in sd), None)
    if prefix is None:
        raise KeyError(
            "Could not locate BERT embeddings in state dict; keys sample: "
            + ", ".join(list(sd.keys())[:5])
        )

    def get(name: str) -> np.ndarray:
        return np.asarray(sd[prefix + name], dtype=np.float32)

    def stack(name: str, transpose: bool) -> np.ndarray:
        arrs = [get(f"encoder.layer.{i}.{name}") for i in range(config.num_layers)]
        return np.stack([a.T if transpose else a for a in arrs])

    params: Params = {
        "embeddings": {
            ours: torch.from_numpy(get(hf).copy()) for ours, hf in EMBEDDING_MAP.items()
        },
        "layers": {
            ours: torch.from_numpy(stack(hf, transpose))
            for ours, (hf, transpose) in LAYER_MAP.items()
        },
    }
    tokenizer = None
    if (model_dir / "vocab.txt").exists():
        tokenizer = WordPieceTokenizer.load(model_dir)
    return params, config, tokenizer
