"""Fused serving pipeline: tokenized batch -> top-k in one call.

Counterpart of the JAX package's ``serve/pipeline.py``. Only token ids go to
the device (int16 when the vocab fits); the mask is recomputed there. The
result comes back as ONE ``[B, 2k]`` int32 tensor, the f32 scores bitcast
into the first k columns and the indices in the last k, so the host makes a
single transfer; ``unpack`` splits it.
"""

from __future__ import annotations

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    TowerConfig,
    prepare_layers,
)
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import (
    encode_from_ids,
    wire_dtype,
)
from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
from instacart_next_order_recommendation_tpu_torch.utils.profiling import span


class FusedServePipeline:
    """ids -> (scores, indices) over a resident catalog, in one call."""

    def __init__(
        self,
        params,
        config: TowerConfig,
        catalog: torch.Tensor,
        n_valid: int,
        pad_id: int = 0,
        layers: list[dict] | None = None,
        device: str | torch.device | None = None,
        packed: bool = False,
    ):
        """``params`` and ``catalog`` must already be on ``device``;
        ``layers`` are the tower's ``prepare_layers`` (made here if omitted);
        ``packed`` selects the packed top-k extraction."""
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.catalog = catalog
        self.n_valid = n_valid
        self.pad_id = pad_id
        self.layers = layers if layers is not None else prepare_layers(params, config)
        self.packed = packed
        self.wire_dtype = wire_dtype(config.vocab_size)

    @torch.inference_mode()
    def topk_device(self, ids: np.ndarray, mask: np.ndarray | None, k: int):
        """Returns the packed ``[B, 2k]`` int32 device tensor and k.

        ``mask`` is accepted for symmetry with the tokenizer's output but
        never transferred: pad positions in ``ids`` determine it on device.
        The upload is the span ``serve.upload``.
        """
        with span("serve.upload"):
            ids_d = torch.from_numpy(np.ascontiguousarray(ids.astype(self.wire_dtype)))
            ids_d = ids_d.to(self.device)
        return self.run_device(ids_d, k)

    @torch.inference_mode()
    def run_device(self, ids_d: torch.Tensor, k: int):
        """``topk_device`` on ids already on the device (``wire_dtype``): the
        span ``serve.launch``."""
        with span("serve.launch"):
            k = min(k, self.n_valid)
            emb = encode_from_ids(
                self.params, ids_d, config=self.config, pad_id=self.pad_id, layers=self.layers
            )
            s, i = cosine_topk(emb, self.catalog, k, n_valid=self.n_valid, packed=self.packed)
            return torch.cat([s.view(torch.int32), i], dim=1), k

    @staticmethod
    def unpack(packed: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        scores = np.ascontiguousarray(packed[:, :k]).view(np.float32)
        indices = packed[:, k:]
        return scores, indices

    def topk(
        self, ids: np.ndarray, mask: np.ndarray | None, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        packed, k = self.topk_device(ids, mask, k)
        return self.unpack(packed.cpu().numpy(), k)
