"""On-disk catalog embedding cache.

The same manifest and layout as the JAX package's ``index/embedding_index.py``,
so a cache written by either package is valid for the other when the tower
and corpus are the same: the cache dir is
``corpus_parent/.embedding_index/<sha256(model_dir|corpus_path)[:16]>``
holding ``manifest.json`` (corpus_path, model_dir, corpus_mtime, n_products),
``embeddings.npy`` (float32) and ``product_ids.json``. A load validates the
manifest paths, corpus mtime, and the exact id list; any mismatch is a miss.
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path

import numpy as np

from instacart_next_order_recommendation_tpu_torch.constants import (
    EMBEDDINGS_FILENAME,
    INDEX_SUBDIR,
    MANIFEST_FILENAME,
    PRODUCT_IDS_FILENAME,
)

logger = logging.getLogger(__name__)


class EmbeddingIndex:
    """Disk cache keyed by (model_dir, corpus_path, corpus mtime, id list)."""

    def __init__(self, corpus_path: Path, model_dir: Path | str):
        self.corpus_path = Path(corpus_path).resolve()
        self.model_dir = model_dir
        self._dir = self._index_dir()

    def _index_dir(self) -> Path:
        canonical = f"{self.model_dir!s}|{self.corpus_path!s}"
        name = hashlib.sha256(canonical.encode()).hexdigest()[:16]
        return self.corpus_path.parent / INDEX_SUBDIR / name

    def load(self, product_ids: list[str]) -> np.ndarray | None:
        manifest_path = self._dir / MANIFEST_FILENAME
        if not manifest_path.exists():
            return None
        try:
            meta = json.loads(manifest_path.read_text())
        except (json.JSONDecodeError, OSError):
            return None
        if meta.get("corpus_path") != str(self.corpus_path) or meta.get("model_dir") != str(
            self.model_dir
        ):
            return None
        try:
            if meta.get("corpus_mtime") != self.corpus_path.stat().st_mtime:
                return None
        except OSError:
            return None
        emb_path = self._dir / EMBEDDINGS_FILENAME
        ids_path = self._dir / PRODUCT_IDS_FILENAME
        if not emb_path.exists() or not ids_path.exists():
            return None
        try:
            embeddings = np.load(emb_path)
            cached_ids = json.loads(ids_path.read_text())
        except (OSError, ValueError, json.JSONDecodeError):
            return None
        if cached_ids != product_ids or len(embeddings) != len(product_ids):
            return None
        return embeddings

    def save(self, product_ids: list[str], embeddings: np.ndarray) -> None:
        self._dir.mkdir(parents=True, exist_ok=True)
        try:
            mtime = self.corpus_path.stat().st_mtime
        except OSError:
            mtime = 0
        manifest = {
            "corpus_path": str(self.corpus_path),
            "model_dir": str(self.model_dir),
            "corpus_mtime": mtime,
            "n_products": len(product_ids),
        }
        # Data first, manifest last (atomically): the manifest is the cache
        # validity key, so it must never exist without the embeddings it
        # vouches for.
        np.save(self._dir / EMBEDDINGS_FILENAME, embeddings.astype(np.float32))
        (self._dir / PRODUCT_IDS_FILENAME).write_text(json.dumps(product_ids))
        tmp = self._dir / (MANIFEST_FILENAME + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=2))
        tmp.replace(self._dir / MANIFEST_FILENAME)
        logger.info("Saved embedding index to %s (%d products)", self._dir, len(product_ids))
