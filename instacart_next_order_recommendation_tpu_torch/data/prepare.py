"""Instacart data preparation: CSVs -> (anchor, positive) pairs + IR eval artifacts.

The port's copy of the JAX package's ``data/prepare.py``: on the same CSVs
it writes the same artifacts, byte for byte, under the same directory name.
Text and artifact contracts are those of the reference implementation;
these strings are load-bearing for every later stage:

- product text:  ``Product: X. Aisle: Y. Department: Z.``
- context:       ``[+{days}d w{dow}h{hour}] name, name; ...  Next: ...`` with
  per-order segments from the last ``max_prior_orders`` prior orders and a
  global ``max_product_names`` cap
- split:         last ``eval_frac`` of sorted order ids -> eval
- eval queries:  serve-time strips the ``Next:`` clause
- outputs:       HF datasets + eval_queries/eval_corpus/eval_relevant_docs JSON
  under a param-encoded subdir ``p{..}_mp{..}_ef{..}``

The chunked scan of order_products__prior is one stable-sorted groupby, and
context building uses per-user numpy searchsorted plus list ops over
precomputed name lists. Every sort names its kind as the JAX package's does
(``stable`` where ties must keep CSV order; pandas' and Python's defaults
elsewhere), since a different sort kind reorders ties. ``datasets`` is
imported where the datasets are built, so the package imports without it.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import pandas as pd

from instacart_next_order_recommendation_tpu_torch.constants import (
    AISLES_CSV,
    DATA_PREP_PARAMS_FILENAME,
    DEFAULT_CONFIG_DATA_PREP,
    DEFAULT_DATA_DIR,
    DEFAULT_PROCESSED_DIR,
    DEPARTMENTS_CSV,
    EVAL_CORPUS_FILENAME,
    EVAL_DATASET_SUBDIR,
    EVAL_QUERIES_FILENAME,
    EVAL_RELEVANT_DOCS_FILENAME,
    EVAL_SET_PRIOR,
    EVAL_SET_TRAIN,
    ORDER_PRODUCTS_CHUNK_SIZE,
    ORDER_PRODUCTS_PRIOR_CSV,
    ORDER_PRODUCTS_TRAIN_CSV,
    ORDERS_CSV,
    PRODUCTS_CSV,
)
from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging
from instacart_next_order_recommendation_tpu_torch.utils.config import (
    load_yaml_config,
    resolve_project_path,
)

logger = logging.getLogger(__name__)


def strip_next_order_from_context(context: str) -> str:
    """Remove the trailing ``Next: ...`` clause (serve-time query form)."""
    if " Next:" in context:
        return context.split(" Next:")[0].strip()
    return context


class DataPrepConfig:
    """Typed data-prep configuration loaded from YAML."""

    def __init__(self, raw: dict):
        self.data_dir = resolve_project_path(raw.get("data_dir"), DEFAULT_DATA_DIR)
        self.output_dir = resolve_project_path(raw.get("output_dir"), DEFAULT_PROCESSED_DIR)
        self.max_prior_orders = int(raw.get("max_prior_orders", 5))
        self.max_product_names = int(raw.get("max_product_names", 20))
        self.sample_frac = float(raw["sample_frac"]) if raw.get("sample_frac") is not None else None
        self.eval_frac = float(raw.get("eval_frac", 0.1))
        self.eval_serve_time = bool(raw.get("eval_serve_time", True))
        self.max_target_orders = (
            int(raw["max_target_orders"]) if raw.get("max_target_orders") is not None else None
        )
        self.seed = int(raw.get("seed", 42))

    @classmethod
    def load(cls, config_path: Path | None = None) -> "DataPrepConfig":
        return cls(load_yaml_config(config_path, DEFAULT_CONFIG_DATA_PREP))


class InstacartDataPrep:
    """Builds training pairs and eval artifacts from Instacart CSVs."""

    def __init__(
        self,
        data_dir: Path = DEFAULT_DATA_DIR,
        output_dir: Path = DEFAULT_PROCESSED_DIR,
        max_prior_orders: int = 5,
        max_product_names: int = 20,
        sample_frac: float | None = None,
        eval_frac: float = 0.1,
        eval_serve_time: bool = True,
        max_target_orders: int | None = None,
        seed: int = 42,
    ):
        self.data_dir = Path(data_dir)
        self.output_dir = Path(output_dir)
        self.max_prior_orders = max_prior_orders
        self.max_product_names = max_product_names
        self.sample_frac = sample_frac
        self.eval_frac = eval_frac
        self.eval_serve_time = eval_serve_time
        self.max_target_orders = max_target_orders
        self.seed = seed

    # ------------------------------------------------------------------ pipeline

    def prepare(self):
        """Run the full pipeline; writes artifacts and returns them.

        Returns:
            (train_dataset, eval_dataset_or_None, eval_queries, eval_corpus,
            eval_relevant_docs) — datasets are HF ``datasets.Dataset``.
        """
        out_dir = self.effective_output_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        logger.info("Output subdir: %s", out_dir)

        product_text_map, product_name_map = self._load_product_maps()
        logger.info("[1/7] %d products", len(product_text_map))

        target_orders, history_orders = self._load_orders()
        if self.max_target_orders is not None:
            target_orders = target_orders.head(self.max_target_orders)
        users_needed = set(target_orders["user_id"].tolist())
        history_orders = history_orders[history_orders["user_id"].isin(users_needed)]
        logger.info("[2/7] target: %d orders, history: %d orders", len(target_orders), len(history_orders))

        order_to_names = self._build_order_name_lists(
            set(history_orders["order_id"].tolist()), product_name_map
        )
        logger.info("[3/7] %d orders with products", len(order_to_names))

        order_id_to_context = self._build_user_context(target_orders, history_orders, order_to_names)
        logger.info("[4/7] %d order contexts", len(order_id_to_context))

        train_op = pd.read_csv(self.data_dir / ORDER_PRODUCTS_TRAIN_CSV)
        anchors, positives, order_ids = self._build_pairs(
            train_op, order_id_to_context, product_text_map
        )
        logger.info("[5/7] %d pairs", len(anchors))

        (
            train_anchors,
            train_positives,
            eval_anchors,
            eval_positives,
            eval_order_ids,
        ) = self._split_train_eval(anchors, positives, order_ids, order_id_to_context)

        if self.sample_frac is not None and self.sample_frac < 1.0:
            idx = (
                pd.DataFrame({"i": np.arange(len(train_anchors))})
                .sample(frac=self.sample_frac, random_state=self.seed)["i"]
                .to_numpy()
            )
            train_anchors = [train_anchors[i] for i in idx]
            train_positives = [train_positives[i] for i in idx]

        from datasets import Dataset

        train_dataset = Dataset.from_dict({"anchor": train_anchors, "positive": train_positives})
        eval_dataset = (
            Dataset.from_dict({"anchor": eval_anchors, "positive": eval_positives})
            if eval_anchors
            else None
        )
        logger.info("[6/7] train: %d pairs, eval: %d pairs", len(train_anchors), len(eval_anchors))

        eval_queries, eval_corpus, eval_relevant_docs = self._build_eval_artifacts(
            train_op, eval_order_ids, order_id_to_context, product_text_map
        )

        self._save_outputs(out_dir, train_dataset, eval_dataset, eval_queries, eval_corpus, eval_relevant_docs)
        logger.info("[7/7] Saved to %s", out_dir)
        return train_dataset, eval_dataset, eval_queries, eval_corpus, eval_relevant_docs

    # ------------------------------------------------------------------ steps

    def effective_output_dir(self) -> Path:
        """Param-encoded output subdir, e.g. ``p5_mp20_ef0.1``."""
        parts = [f"p{self.max_prior_orders}", f"mp{self.max_product_names}", f"ef{self.eval_frac}"]
        if not self.eval_serve_time:
            parts.append("no_serve")
        if self.sample_frac is not None:
            parts.append(f"sf{self.sample_frac}")
        if self.max_target_orders is not None:
            parts.append(f"mt{self.max_target_orders}")
        return self.output_dir / "_".join(parts)

    def _load_product_maps(self) -> tuple[dict[int, str], dict[int, str]]:
        """product_id -> full text, and product_id -> display name.

        The display name replicates the reference's extraction
        ``text.split("Product: ")[1].split(".")[0].strip()`` — i.e. the
        product name truncated at its first period.
        """
        products = pd.read_csv(self.data_dir / PRODUCTS_CSV)
        aisles = pd.read_csv(self.data_dir / AISLES_CSV)
        departments = pd.read_csv(self.data_dir / DEPARTMENTS_CSV)
        df = products.merge(aisles, on="aisle_id").merge(departments, on="department_id")
        text = (
            "Product: "
            + df["product_name"].astype(str)
            + ". Aisle: "
            + df["aisle"].astype(str)
            + ". Department: "
            + df["department"].astype(str)
            + "."
        )
        name = df["product_name"].astype(str).str.split(".").str[0].str.strip()
        return (
            dict(zip(df["product_id"], text)),
            dict(zip(df["product_id"], name)),
        )

    def _load_orders(self) -> tuple[pd.DataFrame, pd.DataFrame]:
        orders = pd.read_csv(self.data_dir / ORDERS_CSV)
        # Zero-padded hour strings are preserved verbatim (contract: the hour
        # renders as-is when the CSV column is string-typed).
        if orders["order_hour_of_day"].dtype == object:
            orders["order_hour_of_day"] = orders["order_hour_of_day"].astype(str).str.zfill(2)
        cols = ["order_id", "user_id", "order_number", "order_dow", "order_hour_of_day", "days_since_prior_order"]
        target = orders[orders["eval_set"] == EVAL_SET_TRAIN][cols].copy()
        history = orders[orders["eval_set"] == EVAL_SET_PRIOR][cols].copy()
        return target, history

    def _build_order_name_lists(
        self, history_order_ids: set[int], product_name_map: dict[int, str]
    ) -> dict[int, list[str]]:
        """order_id -> [display names] from order_products__prior (chunk-streamed).

        Products keep CSV row order within each order (the reference appends in
        scan order); unknown product ids are dropped.
        """
        frames = []
        path = self.data_dir / ORDER_PRODUCTS_PRIOR_CSV
        for chunk in pd.read_csv(
            path, usecols=["order_id", "product_id"], chunksize=ORDER_PRODUCTS_CHUNK_SIZE
        ):
            sel = chunk[chunk["order_id"].isin(history_order_ids)]
            if len(sel):
                frames.append(sel)
        if not frames:
            return {}
        df = pd.concat(frames, ignore_index=True)
        df["name"] = df["product_id"].map(product_name_map)
        df = df.dropna(subset=["name"])
        # Stable sort preserves CSV order within each order_id group.
        df = df.sort_values("order_id", kind="stable")
        order_ids = df["order_id"].to_numpy()
        names = df["name"].to_numpy()
        boundaries = np.flatnonzero(np.diff(order_ids)) + 1
        groups = np.split(names, boundaries)
        uniq = order_ids[np.concatenate([[0], boundaries])] if len(order_ids) else []
        return {int(oid): list(grp) for oid, grp in zip(uniq, groups)}

    @staticmethod
    def _time_prefix(days, dow, hour) -> str:
        hour_str = hour if isinstance(hour, str) else str(int(hour))
        if pd.isna(days):
            return f"w{int(dow)}h{hour_str}"
        return f"+{int(days)}d w{int(dow)}h{hour_str}"

    def _build_user_context(
        self,
        target_orders: pd.DataFrame,
        history_orders: pd.DataFrame,
        order_to_names: dict[int, list[str]],
    ) -> dict[int, str]:
        """order_id -> full context string (segments + ``Next:`` clause)."""
        history = history_orders.sort_values(["user_id", "order_number"], kind="stable")
        h_user = history["user_id"].to_numpy()
        h_onum = history["order_number"].to_numpy()
        h_oid = history["order_id"].to_numpy()
        h_dow = history["order_dow"].to_numpy()
        h_hour = history["order_hour_of_day"].to_numpy()
        h_days = history["days_since_prior_order"].to_numpy()

        # Per-user slice boundaries into the sorted history arrays.
        user_starts: dict[int, tuple[int, int]] = {}
        if len(h_user):
            change = np.flatnonzero(np.diff(h_user)) + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [len(h_user)]])
            for s, e in zip(starts, ends):
                user_starts[int(h_user[s])] = (int(s), int(e))

        contexts: dict[int, str] = {}
        for oid, uid, onum, dow, hour, days in zip(
            target_orders["order_id"].to_numpy(),
            target_orders["user_id"].to_numpy(),
            target_orders["order_number"].to_numpy(),
            target_orders["order_dow"].to_numpy(),
            target_orders["order_hour_of_day"].to_numpy(),
            target_orders["days_since_prior_order"].to_numpy(),
        ):
            span = user_starts.get(int(uid))
            segments: list[str] = []
            total = 0
            if span is not None:
                s, e = span
                # Orders strictly before the target, most recent max_prior_orders.
                cut = s + int(np.searchsorted(h_onum[s:e], onum, side="left"))
                lo = max(s, cut - self.max_prior_orders)
                for j in range(lo, cut):
                    if total >= self.max_product_names:
                        break
                    names = order_to_names.get(int(h_oid[j]), [])
                    take = names[: self.max_product_names - total]
                    if not take:
                        continue
                    total += len(take)
                    prefix = self._time_prefix(h_days[j], h_dow[j], h_hour[j])
                    segments.append(f"[{prefix}] " + ", ".join(take))
            products_str = "; ".join(segments) if segments else "(no prior orders)"
            next_clause = "Next: " + self._time_prefix(days, dow, hour)
            contexts[int(oid)] = f"{products_str}. {next_clause}"
        return contexts

    def _build_pairs(
        self,
        train_op: pd.DataFrame,
        order_id_to_context: dict[int, str],
        product_text_map: dict[int, str],
    ) -> tuple[list[str], list[str], list[int]]:
        """(anchor, positive, order_id) triples from order_products__train rows.

        ``train_op`` is the already-parsed order_products__train frame —
        prepare() reads the ~1.4M-row CSV once and shares it with
        _build_eval_artifacts instead of parsing it twice per run."""
        ctx = train_op["order_id"].map(order_id_to_context)
        pos = train_op["product_id"].map(product_text_map)
        keep = ctx.notna() & pos.notna()
        return (
            ctx[keep].tolist(),
            pos[keep].tolist(),
            train_op.loc[keep, "order_id"].astype(int).tolist(),
        )

    def _split_train_eval(self, anchors, positives, order_ids, order_id_to_context):
        """Order-level split: numerically-last ``eval_frac`` of order ids -> eval."""
        order_list = sorted(set(order_id_to_context.keys()))
        n_eval = max(1, int(len(order_list) * self.eval_frac))
        eval_order_ids = set(order_list[-n_eval:])
        oid_arr = np.asarray(order_ids)
        is_eval = np.isin(oid_arr, list(eval_order_ids))
        train_anchors = [a for a, m in zip(anchors, is_eval) if not m]
        train_positives = [p for p, m in zip(positives, is_eval) if not m]
        eval_anchors = [a for a, m in zip(anchors, is_eval) if m]
        eval_positives = [p for p, m in zip(positives, is_eval) if m]
        return train_anchors, train_positives, eval_anchors, eval_positives, eval_order_ids

    def _build_eval_artifacts(
        self,
        train_op: pd.DataFrame,
        eval_order_ids: set[int],
        order_id_to_context: dict[int, str],
        product_text_map: dict[int, str],
    ) -> tuple[dict[str, str], dict[str, str], dict[str, list[str]]]:
        if self.eval_serve_time:
            eval_queries = {
                str(oid): strip_next_order_from_context(order_id_to_context[oid])
                for oid in eval_order_ids
                if oid in order_id_to_context
            }
        else:
            eval_queries = {
                str(oid): order_id_to_context[oid]
                for oid in eval_order_ids
                if oid in order_id_to_context
            }

        eval_relevant_docs: dict[str, list[str]] = {str(oid): [] for oid in eval_order_ids}
        sel = train_op[train_op["order_id"].isin(eval_order_ids)]
        for oid, pid in zip(sel["order_id"].to_numpy(), sel["product_id"].to_numpy()):
            eval_relevant_docs[str(int(oid))].append(str(int(pid)))

        eval_corpus = {str(pid): text for pid, text in product_text_map.items()}
        return eval_queries, eval_corpus, eval_relevant_docs

    def _save_outputs(self, out_dir, train_dataset, eval_dataset, eval_queries, eval_corpus, eval_relevant_docs):
        train_dataset.save_to_disk(str(out_dir / "train_dataset"))
        if eval_dataset is not None:
            eval_dataset.save_to_disk(str(out_dir / EVAL_DATASET_SUBDIR))
        with open(out_dir / EVAL_QUERIES_FILENAME, "w") as f:
            json.dump(eval_queries, f, indent=0)
        with open(out_dir / EVAL_CORPUS_FILENAME, "w") as f:
            json.dump(eval_corpus, f, indent=0)
        with open(out_dir / EVAL_RELEVANT_DOCS_FILENAME, "w") as f:
            json.dump(eval_relevant_docs, f, indent=0)
        params = {
            "data_dir": str(self.data_dir),
            "output_dir": str(out_dir),
            "max_prior_orders": self.max_prior_orders,
            "max_product_names": self.max_product_names,
            "sample_frac": self.sample_frac,
            "eval_frac": self.eval_frac,
            "eval_serve_time": self.eval_serve_time,
            "max_target_orders": self.max_target_orders,
            "seed": self.seed,
            "n_train_pairs": len(train_dataset),
            "n_eval_pairs": len(eval_dataset) if eval_dataset else 0,
            "n_eval_queries": len(eval_queries),
            "n_corpus": len(eval_corpus),
        }
        with open(out_dir / DATA_PREP_PARAMS_FILENAME, "w") as f:
            json.dump(params, f, indent=2)


def main(argv: list[str] | None = None) -> int:
    """The data-prep CLI (``python -m instacart_next_order_recommendation_tpu_torch.data``)."""
    parser = argparse.ArgumentParser(description="Prepare Instacart data for two-tower training")
    parser.add_argument("--config", type=Path, default=None, help="Path to YAML config")
    args = parser.parse_args(argv)
    cfg = DataPrepConfig.load(args.config)
    setup_colored_logging(quiet_loggers=["datasets", "urllib3"])
    prep = InstacartDataPrep(
        data_dir=cfg.data_dir,
        output_dir=cfg.output_dir,
        max_prior_orders=cfg.max_prior_orders,
        max_product_names=cfg.max_product_names,
        sample_frac=cfg.sample_frac,
        eval_frac=cfg.eval_frac,
        eval_serve_time=cfg.eval_serve_time,
        max_target_orders=cfg.max_target_orders,
        seed=cfg.seed,
    )
    train_ds, eval_ds, eq, ec, er = prep.prepare()
    logger.info("Train pairs: %d", len(train_ds))
    if eval_ds is not None:
        logger.info("Eval pairs: %d", len(eval_ds))
    logger.info("Eval queries: %d, corpus: %d", len(eq), len(ec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
