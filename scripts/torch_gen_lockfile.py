#!/usr/bin/env python3
"""Pin the PyTorch/CUDA port's environment into a lock file of its own.

The port's counterpart of ``scripts/gen_lockfile.py``: it reads the
installed versions (``importlib.metadata``; nothing is downloaded) of what
the port, its tools and its tests import, and writes them with a header
naming the machine (its card's name and power limit from ``nvidia-smi``,
Python, torch and its CUDA). No JAX package is pinned, and the JAX
environment's ``requirements.lock`` is never written. Run it on the machine
whose environment it pins:

    python3 scripts/torch_gen_lockfile.py [--out requirements-cuda.lock]
"""

from __future__ import annotations

import argparse
import importlib.metadata as md
import platform
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGES = [
    # compute path
    "torch", "numpy",
    # data path and the baselines
    "pandas", "scipy", "pyarrow", "datasets", "msgpack", "safetensors",
    # serving: config, the API's schemas and metrics
    "pyyaml", "pydantic", "prometheus-client",
    # tests
    "pytest",
]


def machine() -> str:
    """The card (``nvidia-smi``'s name and power limit), Python and torch."""
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "no NVIDIA GPU"
    import torch

    return (f"{card}; Python {platform.python_version()}; torch {torch.__version__} "
            f"(CUDA {torch.version.cuda})")


def pins() -> tuple[list[str], list[str]]:
    """``name==version`` of each installed package, and the names absent."""
    found, missing = [], []
    for name in PACKAGES:
        try:
            found.append(f"{name}=={md.version(name)}")
        except md.PackageNotFoundError:
            missing.append(name)
    return found, missing


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=REPO / "requirements-cuda.lock")
    args = parser.parse_args(argv)
    if args.out.resolve() == (REPO / "requirements.lock").resolve():
        print("torch_gen_lockfile: requirements.lock pins the JAX environment; choose another "
              "--out", file=sys.stderr)
        return 2
    found, missing = pins()
    lines = [
        "# Pinned environment of the PyTorch/CUDA port (instacart_next_order_recommendation_"
        "tpu_torch),",
        f"# read on: {machine()}.",
        "# Regenerate with scripts/torch_gen_lockfile.py on the machine it pins.",
    ]
    if missing:
        lines.append(f"# not installed there: {', '.join(missing)}")
    args.out.write_text("\n".join(lines + found) + "\n")
    print(f"wrote {args.out} ({len(found)} pins)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
