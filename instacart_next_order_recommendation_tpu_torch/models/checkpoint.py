"""Tower checkpoint IO: params (msgpack) + model_config.json + vocab.

The same on-disk format as the JAX package's ``models/checkpoint.py``, read
and written without flax: ``params.msgpack`` is a msgpack map of maps whose
arrays are msgpack ext type 1 holding ``[shape, dtype name, raw C-order
bytes]`` (flax's ndarray encoding). A tower saved by either package loads in
the other.
"""

from __future__ import annotations

import json
from pathlib import Path

import msgpack
import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.constants import (
    MODEL_CONFIG_FILENAME,
    PARAMS_FILENAME,
)
from instacart_next_order_recommendation_tpu_torch.models.encoder import Params, TowerConfig
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

_EXT_NDARRAY = 1


def _ext_pack(obj):
    if isinstance(obj, np.ndarray):
        payload = msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialise {type(obj).__name__}")


def _ext_unpack(code: int, data: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code} in {PARAMS_FILENAME}")
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        arr = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def params_to_numpy(params: Params) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu").numpy()


def params_from_numpy(tree: dict) -> Params:
    """Nested dict of array-likes (e.g. the JAX package's params through
    ``np.asarray``) -> nested dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # bfloat16 leaves arrive as tensors
        return tree
    return torch.from_numpy(np.array(tree, copy=True))


def save_tower(
    model_dir: Path | str,
    params: Params,
    config: TowerConfig,
    tokenizer: WordPieceTokenizer | None = None,
) -> None:
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    packed = msgpack.packb(params_to_numpy(params), default=_ext_pack, strict_types=True)
    (model_dir / PARAMS_FILENAME).write_bytes(packed)
    (model_dir / MODEL_CONFIG_FILENAME).write_text(json.dumps(config.to_dict(), indent=2))
    if tokenizer is not None:
        tokenizer.save(model_dir)


def load_tower(
    model_dir: Path | str,
) -> tuple[Params, TowerConfig, WordPieceTokenizer | None]:
    """Load a tower checkpoint: the shared format, or else a Hugging Face
    BERT/MiniLM directory (``config.json`` and its weights, through
    ``models/hf_loader.py``), as the JAX package's ``load_tower`` falls back,
    so a pretrained ``all-MiniLM-L6-v2`` folder warm-starts training and
    serves as it is."""
    model_dir = Path(model_dir)
    cfg_path = model_dir / MODEL_CONFIG_FILENAME
    if not cfg_path.exists():
        if (model_dir / "config.json").exists():
            from instacart_next_order_recommendation_tpu_torch.models.hf_loader import (
                load_hf_tower,
            )

            return load_hf_tower(model_dir)
        raise FileNotFoundError(f"No {MODEL_CONFIG_FILENAME} or config.json in {model_dir}")
    config = TowerConfig.from_dict(json.loads(cfg_path.read_text()))
    tree = msgpack.unpackb(
        (model_dir / PARAMS_FILENAME).read_bytes(), ext_hook=_ext_unpack, raw=False
    )
    params = params_from_numpy(tree)
    tokenizer = None
    if (model_dir / "vocab.txt").exists():
        tokenizer = WordPieceTokenizer.load(model_dir)
    return params, config, tokenizer
