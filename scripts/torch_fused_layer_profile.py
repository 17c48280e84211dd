#!/usr/bin/env python3
"""K1 and K5 launch by launch, and in turns with their library calls, on one NVIDIA GPU.

Traces one K1 call at the MiniLM-L6 serve batch's shape (B=256, S=192) and
one K5 call at the training batches' shapes (B=64 and B=512, S=256, with
dropout masks) through ``chip_smoke.show_breakdown``, then reads each in
turns with its ``nn.TransformerEncoderLayer`` yardstick through
``chip_smoke.ms_in_turns``. Random weights and inputs from fixed seeds;
every batch has an all-pad row.

Run from the repository root on a machine with nvcc:

    python3 scripts/torch_fused_layer_profile.py [--package-root DIR]

``--package-root`` imports the port's package from another checkout (for
example a parent commit unpacked under ``build/tree/``), so that two
versions of the kernels are read by the same script.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
H, INTER, HEADS = 384, 1536, 12
CASES = (("K1", 256, 192), ("K5", 64, 256), ("K5", 512, 256))


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
    from instacart_next_order_recommendation_tpu_torch.ops import (
        _build,
        fused_encoder_layer,
        fused_encoder_layer_backward,
    )
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import draw_dropout_masks

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    cs.log(f"package from {Path(_build.__file__).resolve().parents[2]}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kw = dict(num_heads=HEADS, scale=1.0 / 32**0.5, eps=1e-12)
    g = torch.Generator().manual_seed(5)
    layer = cs.random_layer(H, INTER, g, dev)
    for name, b, s in CASES:
        x, up = (torch.randn((b, s, H), generator=g).to(dev, torch.bfloat16) for _ in range(2))
        mask = cs.random_mask(b, s, g, dev)
        pad = mask == 0
        library = torch.nn.TransformerEncoderLayer(
            d_model=H, nhead=HEADS, dim_feedforward=INTER, dropout=0.1, activation="gelu",
            batch_first=True, norm_first=False,
        ).to(dev, torch.bfloat16)
        if name == "K1":
            library.eval()
            fn = lambda: fused_encoder_layer(x, mask, layer, **kw)  # noqa: E731
            yardstick = lambda: library(x, src_key_padding_mask=pad)  # noqa: E731
        else:
            library.train()
            bias = ((1.0 - mask.float()) * -1e9).contiguous()
            masks = draw_dropout_masks(
                (b, s, H), 0.1, torch.Generator(device=dev).manual_seed(6), dev, torch.bfloat16
            )
            fn = lambda: fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)  # noqa: E731
            yardstick = cs.library_train_calls(library, x, pad, up)[1]
        cs.show_breakdown(f"{name} B={b} S={s}", fn)
        t = cs.ms_in_turns({name: fn, "library": yardstick}, 10 if b * s > 16384 else 20)
        cs.log(f"{name} B={b} S={s} in turns: {name} {t[name]:.4f} ms, library {t['library']:.4f} ms")
        del x, up, library
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
