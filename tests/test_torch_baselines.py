"""The port's baselines and evaluator against the JAX package's on the same
data: item-item CF rankings (identical), the content-based baseline on the
same untrained weights at f32 (IR metrics within 1e-6, ids identical but for
near-ties), the end-to-end IR metrics of one tower through both
``RetrievalEvaluator``s, and the baselines CLI's tables."""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from instacart_next_order_recommendation_tpu.baselines import (
    ContentBasedBaseline as JaxContentBasedBaseline,
    ItemItemCFBaseline as JaxItemItemCFBaseline,
)
from instacart_next_order_recommendation_tpu.baselines import run_baselines as jax_run_baselines
from instacart_next_order_recommendation_tpu.baselines.content_based import (
    untrained_encoder as jax_untrained_encoder,
)
from instacart_next_order_recommendation_tpu.data import InstacartDataPrep
from instacart_next_order_recommendation_tpu.data.synthetic import generate_instacart_csvs
from instacart_next_order_recommendation_tpu.eval.evaluator import (
    RetrievalEvaluator as JaxRetrievalEvaluator,
)
from instacart_next_order_recommendation_tpu.eval.metrics import (
    compute_ir_metrics as jax_compute_ir_metrics,
)
from instacart_next_order_recommendation_tpu.models import save_tower as jax_save_tower
from instacart_next_order_recommendation_tpu_torch.baselines import (
    ContentBasedBaseline,
    ItemItemCFBaseline,
    load_eval_data,
)
from instacart_next_order_recommendation_tpu_torch.baselines import run_baselines
from instacart_next_order_recommendation_tpu_torch.baselines.content_based import (
    untrained_encoder,
)
from instacart_next_order_recommendation_tpu_torch.eval.evaluator import RetrievalEvaluator
from instacart_next_order_recommendation_tpu_torch.eval.metrics import compute_ir_metrics
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_from_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

from tests.helpers import TINY_TOWER
from tests.test_baselines import REFERENCE_ROOT

NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_baselines")
    data_dir = generate_instacart_csvs(base / "data", n_users=50, n_products=90, seed=11)
    prep = InstacartDataPrep(data_dir=data_dir, output_dir=base / "processed", eval_frac=0.3)
    prep.prepare()
    return base, data_dir, prep.effective_output_dir()


@pytest.fixture(scope="module")
def cf_pair(prepared):
    _, data_dir, processed = prepared
    return ItemItemCFBaseline(data_dir, processed), JaxItemItemCFBaseline(data_dir, processed)


@pytest.fixture(scope="module")
def encoders(prepared):
    """A JAX untrained tower at f32 and the port's encoder on the same
    weights and vocab."""
    _, _, processed = prepared
    _, eval_corpus, _ = load_eval_data(processed)
    jax_enc = jax_untrained_encoder(
        list(eval_corpus.values()), vocab_size=800,
        preset=dataclasses.replace(TINY_TOWER, vocab_size=1), max_seq_length=32,
    )
    assert jax_enc.config.compute_dtype == "float32"
    port_enc = TextEncoder(
        params_from_numpy(jax.tree.map(np.asarray, jax_enc.params)),
        TowerConfig.from_dict(jax_enc.config.to_dict()),
        WordPieceTokenizer(dict(jax_enc.tokenizer.vocab), lowercase=jax_enc.tokenizer.lowercase),
        32,
        device="cpu",
    )
    return port_enc, jax_enc


def test_cf_rankings_identical_to_jax(cf_pair):
    ours, theirs = cf_pair
    assert ours.corpus_ids == theirs.corpus_ids
    assert (ours.co_occur != theirs.co_occur).nnz == 0
    assert ours.eval_order_to_history.keys() == theirs.eval_order_to_history.keys()
    for qid, hist in ours.eval_order_to_history.items():
        np.testing.assert_array_equal(hist, theirs.eval_order_to_history[qid])
    assert ours.rank_all() == theirs.rank_all()


def test_cf_excludes_history_and_keeps_corpus_order_on_ties(cf_pair):
    cf, _ = cf_pair
    n = len(cf.corpus_ids)
    row = {pid: i for i, pid in enumerate(cf.corpus_ids)}
    co = cf.co_occur.toarray()
    tied = 0
    for qid, ranked in cf.rank_all().items():
        hist = cf.eval_order_to_history[qid]
        in_hist = set(hist[hist < n].tolist())
        rows = [row[p] for p in ranked]
        assert not in_hist & set(rows)
        assert sorted(rows) == sorted(set(range(n)) - in_hist)  # every other product, once
        scores = co[:n][:, hist].sum(axis=1) if len(hist) else np.zeros(n)
        for a, b in zip(rows, rows[1:]):
            assert scores[a] >= scores[b], qid
            if scores[a] == scores[b]:
                assert a < b, qid  # a tie keeps corpus order
                tied += 1
    assert tied > 0  # the data holds ties, so the order rule was exercised


@pytest.mark.skipif(not REFERENCE_ROOT.exists(), reason="reference repo not mounted")
def test_cf_parity_with_reference(prepared, cf_pair):
    _, data_dir, processed = prepared
    sys.path.insert(0, str(REFERENCE_ROOT))
    try:
        from src.baselines.collaborative_filtering import ItemItemCFBaseline as RefCF

        ref_rankings = RefCF(data_dir, processed).rank_all()
    finally:
        sys.path.remove(str(REFERENCE_ROOT))
        for mod in [m for m in sys.modules if m == "src" or m.startswith("src.")]:
            del sys.modules[mod]
    ours = cf_pair[0].rank_all()
    assert set(ours) == set(ref_rankings)
    _, _, relevant = load_eval_data(processed)
    m_ours, m_ref = compute_ir_metrics(ours, relevant), compute_ir_metrics(ref_rankings, relevant)
    for k in m_ours:
        assert m_ours[k] == pytest.approx(m_ref[k], abs=1e-9), k
    for qid in ours:
        assert ours[qid][:5] == ref_rankings[qid][:5]


def _ids_agree_but_for_near_ties(ours, theirs, sim, pid_row):
    """Every rank where the two lists differ holds two ids whose f64
    cosine scores lie within NEAR_TIE."""
    for qi, qid in enumerate(ours):
        a, b = ours[qid], theirs[qid]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if x != y:
                assert abs(sim[qi, pid_row[x]] - sim[qi, pid_row[y]]) < NEAR_TIE, (qid, x, y)


@pytest.mark.parametrize("top_k", [None, 10])
def test_content_based_matches_jax(prepared, encoders, top_k):
    _, _, processed = prepared
    eval_queries, eval_corpus, relevant = load_eval_data(processed)
    port_enc, jax_enc = encoders
    ours = ContentBasedBaseline(eval_queries, eval_corpus, model=port_enc, batch_size=16)
    theirs = JaxContentBasedBaseline(eval_queries, eval_corpus, model=jax_enc, batch_size=16)
    r_ours, r_theirs = ours.rank_all(top_k=top_k), theirs.rank_all(top_k=top_k)
    assert list(r_ours) == list(r_theirs) == list(eval_queries)
    if top_k is None:
        assert all(sorted(r) == sorted(eval_corpus) for r in r_ours.values())  # full corpus
    else:
        assert all(len(r) == top_k for r in r_ours.values())
    m_ours, m_theirs = compute_ir_metrics(r_ours, relevant), jax_compute_ir_metrics(
        r_theirs, relevant
    )
    assert m_ours.keys() == m_theirs.keys()
    for k in m_ours:
        assert m_ours[k] == pytest.approx(m_theirs[k], abs=1e-6), k
    q = theirs.encoder.encode([eval_queries[x] for x in eval_queries]).astype(np.float64)
    sim = q @ np.asarray(theirs.corpus_embeddings, np.float64).T
    _ids_agree_but_for_near_ties(r_ours, r_theirs, sim, {p: i for i, p in enumerate(eval_corpus)})


def test_untrained_encoder_is_a_seeded_tower_on_the_corpus_vocab(prepared):
    _, _, processed = prepared
    _, eval_corpus, _ = load_eval_data(processed)
    preset = dataclasses.replace(TINY_TOWER, vocab_size=1)
    kw = dict(vocab_size=800, preset=preset, max_seq_length=32, device="cpu")
    a = untrained_encoder(list(eval_corpus.values()), seed=5, **kw)
    b = untrained_encoder(list(eval_corpus.values()), seed=5, **kw)
    c = untrained_encoder(list(eval_corpus.values()), seed=6, **kw)
    assert a.config.vocab_size == a.tokenizer.vocab_size and a.device.type == "cpu"
    assert torch.equal(a.params["layers"]["q_w"], b.params["layers"]["q_w"])
    assert not torch.equal(a.params["layers"]["q_w"], c.params["layers"]["q_w"])


def test_evaluator_end_to_end_matches_jax(prepared, encoders):
    """One tower's weights (f32) and one eval set through both packages'
    ``RetrievalEvaluator``: encode, top-k, metrics."""
    _, _, processed = prepared
    eval_queries, eval_corpus, relevant = load_eval_data(processed)
    port_enc, jax_enc = encoders
    ours = RetrievalEvaluator(eval_queries, eval_corpus, relevant, batch_size=16, top_k=20)(
        port_enc
    )
    theirs = JaxRetrievalEvaluator(eval_queries, eval_corpus, relevant, batch_size=16, top_k=20)(
        jax_enc
    )
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-6), k


def _tables(text: str) -> dict[str, dict[str, float]]:
    """The CLI's ``format_metrics`` tables, parsed: title -> label -> value."""
    out, title = {}, None
    for line in text.splitlines():
        if line.startswith("--- ") and line.endswith(" ---") and "Compare" not in line:
            title = line.strip("- ")
            out[title] = {}
        elif title and line.startswith("  ") and ":" in line:
            label, value = line.split(":")
            out[title][label.strip()] = float(value)
    return out


def test_baselines_cli_prints_the_jax_tables(prepared, encoders, tmp_path, capsys):
    """Both CLIs on one config (a tower written by JAX, CF on the CSVs):
    the same tables, CF's identical, the content-based within rounding."""
    _, data_dir, processed = prepared
    _, jax_enc = encoders
    model_dir = tmp_path / "tower"
    jax_save_tower(model_dir, jax_enc.params, jax_enc.config, jax_enc.tokenizer)
    config = tmp_path / "baselines.yaml"
    config.write_text(yaml.safe_dump(
        {"processed_dir": str(processed), "data_dir": str(data_dir), "model": str(model_dir)}
    ))
    run_baselines.main(["--config", str(config)], device="cpu")
    ours = capsys.readouterr().out
    argv = sys.argv
    sys.argv = ["run_baselines", "--config", str(config)]
    try:
        jax_run_baselines.main()
    finally:
        sys.argv = argv
    theirs = capsys.readouterr().out
    t_ours, t_theirs = _tables(ours), _tables(theirs)
    assert list(t_ours) == list(t_theirs) == [
        "Content-based (untrained tower)", "Collaborative filtering (item-item)"
    ]
    assert t_ours["Collaborative filtering (item-item)"] == t_theirs[
        "Collaborative filtering (item-item)"
    ]
    for label, value in t_ours["Content-based (untrained tower)"].items():
        assert value == pytest.approx(t_theirs["Content-based (untrained tower)"][label], abs=1e-4)
    assert "Compare with the trained two-tower model" in ours
