"""Minimal .env loader (stdlib-only).

The port's copy of the JAX package's ``utils/dotenv.py``: KEY=VALUE lines,
``#`` comments, optional single/double quotes; existing environment
variables win unless ``override``.
"""

from __future__ import annotations

import os
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.constants import PROJECT_ROOT

DEFAULT_DOTENV_PATH = PROJECT_ROOT / ".env"


def load_dotenv(path: Path | str | None = None, override: bool = False) -> dict[str, str]:
    """Load KEY=VALUE pairs from a .env file into os.environ.

    Returns the parsed mapping; missing files are a silent no-op.
    """
    path = Path(path) if path else DEFAULT_DOTENV_PATH
    if not path.is_file():
        return {}
    parsed: dict[str, str] = {}
    for raw_line in path.read_text().splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        if key:
            parsed[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return parsed
