#!/usr/bin/env python3
"""K3 and K4 (the cosine top-k kernels) timed on one NVIDIA GPU.

Builds ``csrc/topk.cu``, prints ptxas's registers and spills per kernel,
then runs ``chip_smoke``'s top-k readings: ``Smoke.time_topk`` (K3 at B in
{1, 256} over 50k unit rows at D=384 and 768, k=16, and at k in {10, 100,
256}; K4 at B in {8, 256}) and ``Smoke.compare_packed_topk`` (K4 against K3
over 1M x 384 unit rows at B in {8, 256}, k=10). Each reading is held
against the plain version and gives CUDA-event milliseconds, the profiler's
split into the slice kernel and the merge, the bound on TF32 tensor cores
and on f32 FMA, and torch.topk(torch.mm(q, C.T), k), two calls, for
reference. Exits 1 if a reading disagrees with its plain version.

Run from the repository root on a machine with nvcc:

    python3 scripts/torch_topk_profile.py [--package-root DIR]

``--package-root`` imports the port's package from another checkout (for
example a parent commit unpacked under ``build/tree/``), so that two
versions of the kernels are read by the same script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", type=Path, default=REPO)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    # chip_smoke's helpers import the package when called, so another
    # checkout's root goes first on the path from here on.
    sys.path.insert(0, str(args.package_root.resolve()))
    from instacart_next_order_recommendation_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    cs.log(f"package from {Path(_build.__file__).resolve().parents[2]}")
    logs = _build.build(("topk",))
    cs.log(f"ptxas (registers, spill stores): {json.dumps(_build.ptxas_usage(logs['topk']))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smoke = cs.Smoke()
    with torch.inference_mode():
        smoke.time_topk(dev)
        smoke.compare_packed_topk(dev)
    if smoke.failures:
        cs.log(f"FAILED: {smoke.failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
