"""Processed-data directory resolution.

The port's copy of ``resolve_processed_dir`` from the JAX package's
``utils/resolve.py``: param-subdir auto-selection under the default
processed dir.
"""

from __future__ import annotations

from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.constants import TRAIN_DATASET_SUBDIR


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
            "(python -m instacart_next_order_recommendation_tpu.data.prepare) "
            "or point processed_dir at a param subdir (e.g. processed/p5_mp20_ef0.1)."
        )
    return processed_dir, None
