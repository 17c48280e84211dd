#!/usr/bin/env python3
"""K1 and K5 launch by launch, product by product and in turns with their yardsticks, on one NVIDIA GPU.

Five parts, ending with one JSON line on stdout (and in ``--out``):

- ``trace`` (the default): one K1 call at the MiniLM-L6 serve batch's
  shape (B=256, S=192) and one K5 call at the training batches' shapes
  (B=64 and B=512, S=256, with dropout masks) traced launch by launch
  through ``chip_smoke.show_breakdown``, then each read in turns with its
  ``nn.TransformerEncoderLayer`` yardstick through ``chip_smoke.ms_in_turns``.
- ``products``: every product of the GEMM core that K1 (four) and K5 (four
  dgrad, four weight gradients) run, at the MiniLM-L6 and mpnet-base-class
  serve batches (B=256, S=192) and training batches (MiniLM B=64 and B=512,
  mpnet B=64; S=256), each held to its plain version and read in turns
  with ``torch.matmul`` on the same operands, beside its bound (2 M N K at
  989 TFLOP/s): ``chip_smoke.Smoke.compare_gemm_core``.
- ``layers``: K1 at both widths' serve batch, and K1-train, K5 and K5's
  resid form at the three training shapes, each read in turns with its
  yardstick (medians of five) through ``chip_smoke.measure_k1`` and
  ``chip_smoke.measure_train_kernels``.
- ``b1``: K1, and a training layer's step (K1-train then K5), at one
  recommend's shape (B=1, S=64) at both widths, calls back to back (where
  the host's launch path, tensor maps included, sets the time) and each
  call's device time alone.
- ``query``: ``chip_smoke.py`` phase 3's single query end to end,
  ``Recommender.recommend`` (top-10) over its 50k-product catalog with the
  MiniLM-L6 and the mpnet-base-class tower (p50 and p95 of ``QUERIES``
  calls on the host's clock), and the host time of one K1 call at B=1 S=64
  (the wrapper's return, no sync: its launch path alone). The towers,
  tokenizer and corpus are written once under ``build/chip_smoke_query/``
  and read by later calls, so that every package serves the same files.

Random weights and inputs from fixed seeds; every batch above 1 has an
all-pad row. Run from the repository root on a machine with nvcc:

    python3 scripts/torch_fused_layer_profile.py [--part trace|products|layers|b1|query ...] \\
        [--package-root DIR] [--out FILE]

``--package-root`` imports the port's package from another checkout (a
parent commit unpacked under ``build/tree/``), so that two versions of the
kernels are read by the same script (``trace``, ``layers``, ``b1`` and ``query``;
``products`` needs this checkout's ``fused_layer.gemm_core``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SERVE = ((256, 192),)
TRAIN = ((64, 256), (512, 256))


TRACE_CASES = (("K1", 256, 192), ("K5", 64, 256), ("K5", 512, 256))


def trace(cs, dev) -> list[dict]:
    """K1 (serve shape) and K5 (B=64 and B=512, S=256) at MiniLM-L6's widths,
    launch by launch, then in turns with their yardsticks."""
    from instacart_next_order_recommendation_tpu_torch.ops import (
        fused_encoder_layer,
        fused_encoder_layer_backward,
    )
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import draw_dropout_masks

    h, heads, inter = cs.MINILM_WIDTHS
    kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
    g = torch.Generator().manual_seed(5)
    layer = cs.random_layer(h, inter, g, dev)
    rows = []
    for name, b, s in TRACE_CASES:
        x, up = (torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16) for _ in range(2))
        mask = cs.random_mask(b, s, g, dev)
        pad = mask == 0
        library = torch.nn.TransformerEncoderLayer(
            d_model=h, nhead=heads, dim_feedforward=inter, dropout=0.1, activation="gelu",
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
                (b, s, h), 0.1, torch.Generator(device=dev).manual_seed(6), dev, torch.bfloat16
            )
            fn = lambda: fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)  # noqa: E731
            yardstick = cs.library_train_calls(library, x, pad, up)[1]
        cs.show_breakdown(f"{name} B={b} S={s}", fn)
        t = cs.ms_in_turns({name: fn, "library": yardstick}, 10 if b * s > 16384 else 20)
        cs.log(f"{name} B={b} S={s} in turns: {name} {t[name]:.4f} ms, library {t['library']:.4f} ms")
        rows.append(dict(kernel=name, b=b, s=s, ms=t[name], library_ms=t["library"]))
        del x, up, library
        torch.cuda.empty_cache()
    return rows


def layers(cs, dev) -> list[dict]:
    """K1 at the serve shapes; K1-train, K5 and K5-resid at the training
    shapes (mpnet at B=64 only), each with its yardstick."""
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import draw_dropout_masks

    rows = []
    for name, (h, heads, inter) in (("MiniLM", cs.MINILM_WIDTHS), ("mpnet", cs.MPNET_WIDTHS)):
        kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
        g = torch.Generator().manual_seed(5)
        layer = cs.random_layer(h, inter, g, dev)
        for b, s in SERVE:
            x = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
            with torch.inference_mode():
                row, _ = cs.measure_k1(x, cs.random_mask(b, s, g, dev), layer, kw)
            rows.append(dict(kernel="K1", widths=name, b=b, s=s, **row))
            cs.log(f"{json.dumps(rows[-1])}")
        for b, s in TRAIN if name == "MiniLM" else TRAIN[:1]:
            x, up = (torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16) for _ in range(2))
            mask = cs.random_mask(b, s, g, dev)
            masks = draw_dropout_masks(
                (b, s, h), 0.1, torch.Generator(device=dev).manual_seed(6), dev, torch.bfloat16
            )
            library = torch.nn.TransformerEncoderLayer(
                d_model=h, nhead=heads, dim_feedforward=inter, dropout=0.1, activation="gelu",
                batch_first=True, norm_first=False,
            ).to(dev, torch.bfloat16).train()
            k1, k5, worst, finite = cs.measure_train_kernels(
                x, mask, layer, masks, up, library, kw, 10 if b * s > 16384 else 20, 1
            )
            resid = k5.pop("resid")
            for kernel, row in (("K1-train", k1), ("K5", k5), ("K5-resid", resid)):
                rows.append(dict(kernel=kernel, widths=name, b=b, s=s, finite=finite, **row))
                cs.log(f"{json.dumps(rows[-1])}")
            del x, up, masks, library
            torch.cuda.empty_cache()
    return rows


def single_query(cs, dev, iters: int = 200) -> list[dict]:
    """K1, and one training layer's step (K1-train then K5), at one
    recommend's shape (B=1, S=64: 64 rows into each GEMM) at both widths,
    where the host's launch path sets the time: back-to-back calls
    (``cuda_ms``, medians of five readings of ``iters`` calls) and each
    call's device time alone (``warm_ms``: queued behind a spin)."""
    from instacart_next_order_recommendation_tpu_torch.ops import (
        fused_encoder_layer,
        fused_encoder_layer_backward,
        fused_encoder_layer_train,
    )
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import draw_dropout_masks

    rows = []
    for name, (h, heads, inter) in (("MiniLM", cs.MINILM_WIDTHS), ("mpnet", cs.MPNET_WIDTHS)):
        kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
        g = torch.Generator().manual_seed(5)
        layer = cs.random_layer(h, inter, g, dev)
        x, up = (torch.randn((1, 64, h), generator=g).to(dev, torch.bfloat16) for _ in range(2))
        mask = cs.random_mask(1, 64, g, dev)
        bias = ((1.0 - mask.float()) * -1e9).contiguous()
        masks = draw_dropout_masks(
            (1, 64, h), 0.1, torch.Generator(device=dev).manual_seed(6), dev, torch.bfloat16
        )

        def forward():
            return fused_encoder_layer(x, mask, layer, **kw)

        def step():
            fused_encoder_layer_train(x, mask, layer, masks=masks, dropout_rate=0.1, **kw)
            return fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)

        with torch.inference_mode():
            for kernel, fn in (("K1", forward), ("K1-train + K5", step)):
                rows.append(dict(kernel=kernel, widths=name, b=1, s=64,
                                 back_to_back_ms=cs.cuda_ms_median(fn, iters),
                                 device_ms=cs.warm_ms(fn, iters // 4)))
                cs.log(json.dumps(rows[-1]))
    return rows


QUERIES = 400
QUERY_WORKDIR = REPO / "build" / "chip_smoke_query"


def _query_files(cs) -> tuple[list[str], dict[str, Path], Path]:
    """Phase 3's catalog, queries, tokenizer and both towers (random weights,
    seed 0), written on the first call and read on later ones."""
    import numpy as np

    from instacart_next_order_recommendation_tpu_torch.models.checkpoint import save_tower
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MINILM_L6,
        MPNET_BASE_CLASS,
        init_params,
    )
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer
    from instacart_next_order_recommendation_tpu_torch.utils.bench_texts import (
        build_catalog_texts,
        build_query_texts,
    )

    towers = {"MiniLM": QUERY_WORKDIR / "minilm", "mpnet": QUERY_WORKDIR / "mpnet"}
    corpus_path, queries_path = QUERY_WORKDIR / "eval_corpus.json", QUERY_WORKDIR / "queries.json"
    if not queries_path.exists():
        rng = np.random.default_rng(0)
        catalog = build_catalog_texts(cs.N_PRODUCTS, rng)
        queries = build_query_texts(QUERIES, catalog, rng)
        tok = WordPieceTokenizer.train(catalog, vocab_size=30_000)
        for name, preset in (("MiniLM", MINILM_L6), ("mpnet", MPNET_BASE_CLASS)):
            config = preset if name == "mpnet" else dataclasses.replace(
                preset, vocab_size=tok.vocab_size)
            save_tower(towers[name], init_params(config, torch.Generator().manual_seed(0)),
                       config, tok)
        corpus_path.write_text(json.dumps({str(i + 1): t for i, t in enumerate(catalog)}))
        queries_path.write_text(json.dumps(queries))
    return json.loads(queries_path.read_text()), towers, corpus_path


def serve_query(cs, dev, iters: int = 500) -> list[dict]:
    """Single recommends at both widths (p50 and p95 on the host's clock),
    and the host time of one K1 call at B=1 S=64 (median of ``iters``)."""
    import time

    import numpy as np

    from instacart_next_order_recommendation_tpu_torch.ops import fused_encoder_layer
    from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender

    queries, towers, corpus_path = _query_files(cs)
    rows = []
    for name, (h, heads, inter) in (("MiniLM", cs.MINILM_WIDTHS), ("mpnet", cs.MPNET_WIDTHS)):
        rec = Recommender(towers[name], corpus_path, use_index=False)
        for q in queries[:20]:  # warm-up
            rec.recommend(q, top_k=10)
        lat = []
        for q in queries:
            t0 = time.perf_counter()
            rec.recommend(q, top_k=10)
            lat.append((time.perf_counter() - t0) * 1e3)
        del rec
        torch.cuda.empty_cache()
        g = torch.Generator().manual_seed(5)
        layer = cs.random_layer(h, inter, g, dev)
        x = torch.randn((1, 64, h), generator=g).to(dev, torch.bfloat16)
        mask = cs.random_mask(1, 64, g, dev)
        kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
        host_us = []
        with torch.inference_mode():
            for i in range(iters + 50):
                t0 = time.perf_counter()
                fused_encoder_layer(x, mask, layer, **kw)
                if i >= 50:
                    host_us.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
        rows.append(dict(widths=name, queries=len(lat),
                         recommend_p50_ms=float(np.percentile(lat, 50)),
                         recommend_p95_ms=float(np.percentile(lat, 95)),
                         k1_b1_host_us_median=float(np.median(host_us))))
        cs.log(json.dumps(rows[-1]))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--part", action="append",
                        choices=("trace", "products", "layers", "b1", "query"), default=None)
    parser.add_argument("--package-root", type=Path, default=REPO)
    parser.add_argument("--out", type=Path, default=None)
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    package = str(Path(_build.__file__).resolve().parents[2])
    cs.log(f"package from {package}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out: dict = {"card": smi, "package": package}
    smoke = cs.Smoke()
    smoke.smi = smi
    for part in args.part or ["trace"]:
        if part == "trace":
            out["trace"] = trace(cs, dev)
        elif part == "products":
            out["products"] = smoke.compare_gemm_core(dev)
        elif part == "layers":
            out["layers"] = layers(cs, dev)
        elif part == "b1":
            out["b1"] = single_query(cs, dev)
        else:
            out["query"] = serve_query(cs, dev)
    out["failures"] = smoke.failures
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 1 if smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main())
