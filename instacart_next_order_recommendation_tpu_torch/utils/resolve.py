"""Processed-data directory and serving-corpus resolution.

The port's copy of ``resolve_processed_dir`` and
``resolve_corpus_with_hf_fallback`` from the JAX package's
``utils/resolve.py``: param-subdir auto-selection under the default
processed dir, and a Hugging Face Hub fallback for a corpus missing on disk
(``huggingface_hub`` is imported only then).
"""

from __future__ import annotations

import logging
import os
import shutil
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_CORPUS_HF_FILENAME,
    DEFAULT_CORPUS_HF_REPO,
    DEFAULT_CORPUS_HF_REPO_TYPE,
    DEFAULT_QUERIES_HF_FILENAME,
    ENV_CORPUS_HF_REPO,
    ENV_CORPUS_HF_REPO_TYPE,
    EVAL_QUERIES_FILENAME,
    TRAIN_DATASET_SUBDIR,
)

logger = logging.getLogger(__name__)


def resolve_processed_dir(
    processed_dir: Path, default_processed_dir: Path
) -> tuple[Path, str | None]:
    """Resolve the processed-data dir, auto-selecting a param subdir when needed.

    When ``processed_dir`` equals the default and holds no ``train_dataset``,
    searches its immediate subdirs for one that does (e.g. ``p5_mp20_ef0.1``):
    a single match is used directly, multiple matches pick the most recently
    modified. Feedback-merged retrain datasets (``*_fb``) are never picked.
    Returns ``(resolved_path, log_message_or_None)``.

    Raises:
        FileNotFoundError: if no train_dataset can be located.
    """
    processed_dir = Path(processed_dir)
    train_path = processed_dir / TRAIN_DATASET_SUBDIR

    if not train_path.exists() and processed_dir == default_processed_dir and processed_dir.is_dir():
        candidates = [
            d
            for d in processed_dir.iterdir()
            if d.is_dir() and (d / TRAIN_DATASET_SUBDIR).exists() and not d.name.endswith("_fb")
        ]
        if len(candidates) == 1:
            return candidates[0], f"  -> Using param subdir: {candidates[0].name}"
        if len(candidates) > 1:
            latest = max(candidates, key=lambda d: (d / TRAIN_DATASET_SUBDIR).stat().st_mtime)
            return latest, f"  -> Multiple subdirs found, using latest: {latest.name}"

    if not train_path.exists():
        raise FileNotFoundError(
            f"Train dataset not found at {train_path}. Run data prep first "
            "(python -m instacart_next_order_recommendation_tpu_torch.data) "
            "or point processed_dir at a param subdir (e.g. processed/p5_mp20_ef0.1)."
        )
    return processed_dir, None


def resolve_corpus_with_hf_fallback(
    corpus_path: Path,
    *,
    hf_repo: str | None = None,
    hf_repo_type: str | None = None,
) -> Path:
    """Resolve the corpus path, downloading from Hugging Face Hub as fallback.

    A corpus that exists on disk is returned as it is, and nothing else is
    touched. Otherwise the download is best-effort: where it fails (offline,
    no ``huggingface_hub``) this raises FileNotFoundError with remediation.
    """
    path = Path(corpus_path).resolve()
    if path.is_file():
        return path

    repo = hf_repo or os.getenv(ENV_CORPUS_HF_REPO) or DEFAULT_CORPUS_HF_REPO
    repo_type = hf_repo_type or os.getenv(ENV_CORPUS_HF_REPO_TYPE) or DEFAULT_CORPUS_HF_REPO_TYPE

    try:
        from huggingface_hub import hf_hub_download

        local_corpus = Path(
            hf_hub_download(repo_id=repo, filename=DEFAULT_CORPUS_HF_FILENAME, repo_type=repo_type)
        )
        # Best-effort: place eval_queries.json next to the corpus so
        # eval_query_id lookups work for demos.
        try:
            local_queries = Path(
                hf_hub_download(
                    repo_id=repo, filename=DEFAULT_QUERIES_HF_FILENAME, repo_type=repo_type
                )
            )
            target = local_corpus.parent / EVAL_QUERIES_FILENAME
            if not target.exists():
                shutil.copy2(local_queries, target)
        except Exception:  # noqa: BLE001 - the corpus alone still serves
            logger.info("eval_queries.json not available in %s; eval_query_id disabled.", repo)
        return local_corpus
    except Exception as exc:  # noqa: BLE001 - any hub failure means "not found"
        raise FileNotFoundError(
            f"eval_corpus.json not found at {path} and download from {repo} failed: {exc}. "
            "Run data prep first."
        ) from exc
