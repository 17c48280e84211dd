"""TextEncoder: batched text -> unit-norm embeddings on the GPU.

Counterpart of the JAX package's ``models/text_encoder.py``. Batches pad to
the tokenizer's length buckets; only token ids cross to the device (int16
when the vocab fits), and the attention mask is recomputed there from the
pad positions.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    Params,
    TowerConfig,
    encode,
    prepare_layers,
)
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer


def encode_from_ids(
    params: Params,
    ids: torch.Tensor,
    *,
    config: TowerConfig,
    pad_id: int,
    layers: list[dict] | None = None,
) -> torch.Tensor:
    """Tower forward from token ids alone. The tokenizer never emits
    ``pad_id`` for a real token, so ``ids != pad_id`` is the attention mask;
    it is computed on the ids' device."""
    mask = (ids != pad_id).to(torch.int32)
    return encode(params, ids, mask, config, layers=layers)


def wire_dtype(vocab_size: int):
    """Dtype of the ids sent to the device: int16 when the vocab fits."""
    return np.int16 if vocab_size <= np.iinfo(np.int16).max else np.int32


def params_to_device(params: Params, device: torch.device) -> Params:
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    return params.to(device)


class TextEncoder:
    """Callable tower over text: tokenization + forward + normalisation."""

    def __init__(
        self,
        params: Params,
        config: TowerConfig,
        tokenizer: WordPieceTokenizer,
        max_seq_length: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.params = params_to_device(params, self.device)
        self.config = config
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length or config.max_seq_length
        with torch.no_grad():
            self.layers = prepare_layers(self.params, config)
        self.wire_dtype = wire_dtype(tokenizer.vocab_size)

    @classmethod
    def load(
        cls,
        model_dir: Path | str,
        max_seq_length: int | None = None,
        device: str | torch.device | None = None,
    ) -> "TextEncoder":
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower

        params, config, tokenizer = load_tower(model_dir)
        if tokenizer is None:
            raise FileNotFoundError(f"No vocab.txt in {model_dir}")
        return cls(params, config, tokenizer, max_seq_length, device)

    def with_params(self, params: Params) -> "TextEncoder":
        """A view of this encoder on other params (on its device), with the
        bf16 layer copies made anew from them; training eval uses it."""
        new = TextEncoder.__new__(TextEncoder)
        new.__dict__.update(self.__dict__)
        new.params = params_to_device(params, self.device)
        with torch.no_grad():
            new.layers = prepare_layers(new.params, self.config)
        return new

    def upload_ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids.astype(self.wire_dtype))).to(self.device)

    def _run_encode(self, ids_d: torch.Tensor) -> torch.Tensor:
        return encode_from_ids(
            self.params,
            ids_d,
            config=self.config,
            pad_id=self.tokenizer.pad_id,
            layers=self.layers,
        )

    @torch.inference_mode()
    def encode_device(
        self,
        texts: Sequence[str],
        pad_batch_to: int | None = None,
        keep_padding: bool = False,
    ) -> torch.Tensor:
        """Encode one batch into a device tensor, without a host sync.

        ``keep_padding=True`` returns all ``pad_batch_to`` rows (pad rows at
        the tail are the embeddings of empty rows).
        """
        ids, _ = self.tokenizer.encode_batch(
            texts, max_seq_length=self.max_seq_length, pad_batch_to=pad_batch_to
        )
        emb = self._run_encode(self.upload_ids(ids))
        if keep_padding or emb.shape[0] == len(texts):
            return emb
        return emb[: len(texts)]

    def encode(
        self, texts: Sequence[str], batch_size: int = 64, sort_by_length: bool = True
    ) -> np.ndarray:
        """Encode texts to a ``[len(texts), hidden]`` float32 unit-norm matrix
        on the host, in input order."""
        return self.encode_resident(
            texts, batch_size=batch_size, sort_by_length=sort_by_length
        ).cpu().numpy()

    @torch.inference_mode()
    def encode_resident(
        self, texts: Sequence[str], batch_size: int = 1024, sort_by_length: bool = True
    ) -> torch.Tensor:
        """Encode texts into a device-resident ``[n, hidden]`` f32 matrix,
        in input order.

        ``sort_by_length`` groups similar-length texts into the same batch
        so each batch pads to the smallest length bucket that fits it; the
        result is permuted back on the device. Each batch pads to
        ``batch_size`` rows, so the kernels see few distinct shapes.
        """
        n = len(texts)
        if n == 0:
            return torch.zeros((0, self.config.hidden_size), device=self.device)
        if sort_by_length and n > batch_size:
            order = np.argsort([len(t) for t in texts], kind="stable")
        else:
            order = np.arange(n)
        chunks = []
        for lo in range(0, n, batch_size):
            batch = [texts[order[i]] for i in range(lo, min(lo + batch_size, n))]
            ids, _ = self.tokenizer.encode_batch(
                batch, max_seq_length=self.max_seq_length, pad_batch_to=batch_size
            )
            chunks.append(self._run_encode(self.upload_ids(ids))[: len(batch)])
        emb = torch.cat(chunks, dim=0) if len(chunks) > 1 else chunks[0]
        if not np.array_equal(order, np.arange(n)):
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            emb = emb[torch.from_numpy(inv).to(self.device)]
        return emb
