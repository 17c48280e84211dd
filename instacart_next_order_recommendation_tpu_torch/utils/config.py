"""YAML config loading for the port's entry points.

The port's copy of the JAX package's ``utils/config.py``. ``yaml`` is
imported where a file is read, so the package imports without it.
"""

from __future__ import annotations

from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.constants import PROJECT_ROOT


def load_yaml_config(config_path: Path | str | None, default_path: Path) -> dict:
    """Load a YAML config file, resolving relative paths against PROJECT_ROOT.

    Returns an empty dict for an empty file; a missing default config file
    also yields an empty dict, so tools run with their in-code defaults.
    """
    path = Path(config_path) if config_path else default_path
    if not path.is_absolute():
        path = PROJECT_ROOT / path
    if config_path is None and not path.exists():
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def resolve_project_path(value: str | Path | None, default: Path) -> Path:
    """Resolve a possibly-relative path string against PROJECT_ROOT."""
    if not value:
        return default
    path = Path(value)
    return path if path.is_absolute() else PROJECT_ROOT / path
