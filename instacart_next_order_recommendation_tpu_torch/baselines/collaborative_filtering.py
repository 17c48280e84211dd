"""Item-item collaborative-filtering baseline (co-occurrence counts).

The port's copy of the JAX package's ``baselines/collaborative_filtering.py``,
with the same semantics: score(candidate) = sum over the user's prior
products h of co_occur(candidate, h), where co-occurrence counts the orders
holding both products; a user's history is the products of their prior
orders numbered below the eval order; candidates already in the history are
left out of the ranking; ties keep corpus order (stable sort).

The co-occurrence matrix is ``B^T B`` for the sparse order x product
incidence matrix, so a query's scores are one sparse column sum, where a
dict of pair counts filled by nested loops over every order takes hours at
Instacart's size. It runs on the host (pandas and scipy), as in the JAX
package.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import pandas as pd
from scipy import sparse

from instacart_next_order_recommendation_tpu_torch.constants import (
    EVAL_CORPUS_FILENAME,
    EVAL_QUERIES_FILENAME,
    EVAL_RELEVANT_DOCS_FILENAME,
    EVAL_SET_PRIOR,
    EVAL_SET_TRAIN,
    ORDER_PRODUCTS_CHUNK_SIZE,
    ORDER_PRODUCTS_PRIOR_CSV,
    ORDERS_CSV,
)

logger = logging.getLogger(__name__)


def load_eval_data(
    processed_dir: Path,
) -> tuple[dict[str, str], dict[str, str], dict[str, set[str]]]:
    """Load eval_queries, eval_corpus, eval_relevant_docs from a processed dir."""
    processed_dir = Path(processed_dir)
    with open(processed_dir / EVAL_QUERIES_FILENAME) as f:
        eval_queries = json.load(f)
    with open(processed_dir / EVAL_CORPUS_FILENAME) as f:
        eval_corpus = json.load(f)
    with open(processed_dir / EVAL_RELEVANT_DOCS_FILENAME) as f:
        eval_relevant_docs = {k: set(v) for k, v in json.load(f).items()}
    return eval_queries, eval_corpus, eval_relevant_docs


class ItemItemCFBaseline:
    """score(candidate) = Σ_h co_occur(candidate, h) over the user's history."""

    def __init__(
        self,
        data_dir: Path,
        processed_dir: Path,
        order_products_chunk_size: int = ORDER_PRODUCTS_CHUNK_SIZE,
    ):
        self.data_dir = Path(data_dir)
        self.processed_dir = Path(processed_dir)
        self.chunk_size = order_products_chunk_size
        self._build()

    def _build(self) -> None:
        orders = pd.read_csv(self.data_dir / ORDERS_CSV)
        train_orders = orders[orders["eval_set"] == EVAL_SET_TRAIN][
            ["order_id", "user_id", "order_number"]
        ]
        prior_orders = orders[orders["eval_set"] == EVAL_SET_PRIOR][
            ["order_id", "user_id", "order_number"]
        ]

        with open(self.processed_dir / EVAL_QUERIES_FILENAME) as f:
            eval_q = json.load(f)
        eval_order_ids = {int(oid) for oid in eval_q}

        train_eval = train_orders[train_orders["order_id"].isin(eval_order_ids)]
        users_eval = set(train_eval["user_id"].tolist())
        prior_orders = prior_orders[prior_orders["user_id"].isin(users_eval)]
        prior_order_ids = set(prior_orders["order_id"].tolist())

        # Stream order_products__prior, keep rows of relevant prior orders.
        frames = []
        for chunk in pd.read_csv(
            self.data_dir / ORDER_PRODUCTS_PRIOR_CSV,
            usecols=["order_id", "product_id"],
            chunksize=self.chunk_size,
        ):
            sel = chunk[chunk["order_id"].isin(prior_order_ids)]
            if len(sel):
                frames.append(sel)
        op = (
            pd.concat(frames, ignore_index=True)
            if frames
            else pd.DataFrame(columns=["order_id", "product_id"])
        )
        op["product_id"] = op["product_id"].astype(int).astype(str)
        op = op.drop_duplicates(["order_id", "product_id"])

        # Corpus defines the candidate id space (reference ranks corpus only).
        with open(self.processed_dir / EVAL_CORPUS_FILENAME) as f:
            corpus = json.load(f)
        self.corpus_ids: list[str] = list(corpus.keys())

        # Product index space = corpus ids + any history-only products.
        corpus_set = set(self.corpus_ids)
        extra = [p for p in op["product_id"].unique() if p not in corpus_set]
        self._pid_index = {p: i for i, p in enumerate(self.corpus_ids)}
        for p in extra:
            self._pid_index[p] = len(self._pid_index)
        n_products = len(self._pid_index)

        order_codes, order_uniques = pd.factorize(op["order_id"])
        prod_codes = op["product_id"].map(self._pid_index).to_numpy()
        incidence = sparse.csr_matrix(
            (np.ones(len(op), dtype=np.int64), (order_codes, prod_codes)),
            shape=(len(order_uniques), n_products),
        )
        # Co-occurrence counts orders containing both products; the diagonal
        # (self-pairs) matches the reference's a==b single increment.
        self.co_occur = (incidence.T @ incidence).tocsr()

        # Per-eval-order history: products from the user's prior orders with
        # order_number < the eval order's order_number.
        order_products: dict[int, np.ndarray] = {}
        rows_by_order = op.groupby("order_id")["product_id"].apply(list)
        for oid, pids in rows_by_order.items():
            order_products[int(oid)] = np.array([self._pid_index[p] for p in pids])

        prior_by_user: dict[int, list[tuple[int, int]]] = {}
        for oid, uid, onum in prior_orders[["order_id", "user_id", "order_number"]].itertuples(
            index=False
        ):
            prior_by_user.setdefault(int(uid), []).append((int(onum), int(oid)))

        train_info = {
            int(oid): (int(uid), int(onum))
            for oid, uid, onum in train_eval[["order_id", "user_id", "order_number"]].itertuples(
                index=False
            )
        }

        self.eval_order_to_history: dict[str, np.ndarray] = {}
        for order_id in eval_order_ids:
            info = train_info.get(order_id)
            if info is None:
                continue
            uid, onum = info
            cols: list[np.ndarray] = []
            for prior_onum, prior_oid in prior_by_user.get(uid, []):
                if prior_onum < onum and prior_oid in order_products:
                    cols.append(order_products[prior_oid])
            hist = np.unique(np.concatenate(cols)) if cols else np.array([], dtype=np.int64)
            self.eval_order_to_history[str(order_id)] = hist
        for qid in eval_q:
            self.eval_order_to_history.setdefault(qid, np.array([], dtype=np.int64))

    def rank_all(self, eval_query_ids: list[str] | None = None) -> dict[str, list[str]]:
        """query_id -> corpus product ids ranked by CF score descending."""
        if eval_query_ids is None:
            eval_query_ids = list(self.eval_order_to_history.keys())
        n_corpus = len(self.corpus_ids)
        corpus_arr = np.asarray(self.corpus_ids, dtype=object)
        out: dict[str, list[str]] = {}
        for qid in eval_query_ids:
            history = self.eval_order_to_history.get(qid, np.array([], dtype=np.int64))
            if len(history):
                scores = np.asarray(
                    self.co_occur[:, history].sum(axis=1)
                ).ravel()[:n_corpus].astype(np.float64)
            else:
                scores = np.zeros(n_corpus)
            in_history = np.zeros(n_corpus, dtype=bool)
            hist_in_corpus = history[history < n_corpus]
            in_history[hist_in_corpus] = True
            order = np.argsort(-scores, kind="stable")
            order = order[~in_history[order]]
            out[qid] = list(corpus_arr[order])
        return out
