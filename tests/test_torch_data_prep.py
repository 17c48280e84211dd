"""The port's data layer against the JAX package's on the CPU: the synthetic
CSV generator (byte-identical CSVs) and the Instacart data prep (every
artifact identical: the JSON files byte for byte, the datasets' columns
as lists, the directory name), through the classes and through the CLI."""

import filecmp
import json
import sys

import pytest

from instacart_next_order_recommendation_tpu.data import prepare as jax_prepare
from instacart_next_order_recommendation_tpu.data.synthetic import (
    generate_instacart_csvs as jax_generate,
)
from instacart_next_order_recommendation_tpu_torch.data import prepare
from instacart_next_order_recommendation_tpu_torch.data.synthetic import generate_instacart_csvs

CSVS = (
    "aisles.csv", "departments.csv", "order_products__prior.csv",
    "order_products__train.csv", "orders.csv", "products.csv",
)
JSON_ARTIFACTS = (
    "eval_queries.json", "eval_corpus.json", "eval_relevant_docs.json", "data_prep_params.json",
)


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_users=40, n_products=60, seed=0),
        dict(n_users=30, n_products=50, seed=7, long_names=True, orders_per_user=(2, 12),
             basket_size=(1, 14), aisles_per_user=2, reorder_rate=0.8),
    ],
    ids=["defaults", "long_names"],
)
def test_synthetic_csvs_byte_identical(tmp_path, kw):
    ours = generate_instacart_csvs(tmp_path / "port", **kw)
    theirs = jax_generate(tmp_path / "jax", **kw)
    assert sorted(p.name for p in ours.iterdir()) == sorted(CSVS)
    for name in CSVS:
        assert filecmp.cmp(ours / name, theirs / name, shallow=False), name


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    return jax_generate(
        tmp_path_factory.mktemp("csvs") / "data", n_users=70, n_products=90, seed=5,
        long_names=True,
    )


def _same_artifacts(ours, theirs) -> None:
    from datasets import load_from_disk

    assert ours.name == theirs.name
    for name in JSON_ARTIFACTS:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    for sub in ("train_dataset", "eval_dataset"):
        assert (ours / sub).exists() == (theirs / sub).exists(), sub
        if (ours / sub).exists():
            a, b = load_from_disk(str(ours / sub)), load_from_disk(str(theirs / sub))
            assert a.column_names == b.column_names == ["anchor", "positive"]
            for col in a.column_names:
                assert list(a[col]) == list(b[col]), (sub, col)


def _prep_both(tmp_path, module_ours, module_theirs, **kw):
    """Runs JAX's prep, moves its output aside, then the port's into the same
    path (so ``data_prep_params.json`` names the same output dir)."""
    out = tmp_path / "processed"
    theirs_prep = module_theirs.InstacartDataPrep(output_dir=out, **kw)
    returned_theirs = theirs_prep.prepare()
    theirs_dir = out.rename(tmp_path / "processed_jax") / theirs_prep.effective_output_dir().name
    ours_prep = module_ours.InstacartDataPrep(output_dir=out, **kw)
    returned_ours = ours_prep.prepare()
    assert ours_prep.effective_output_dir() == theirs_prep.effective_output_dir()
    return ours_prep.effective_output_dir(), theirs_dir, returned_ours, returned_theirs


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(max_product_names=3),
        dict(max_prior_orders=2, eval_frac=0.25),
        dict(eval_serve_time=False, sample_frac=0.5, max_target_orders=40, seed=3),
    ],
    ids=["default", "mp3", "p2_ef0.25", "no_serve_sf_mt"],
)
def test_prep_artifacts_identical(csv_dir, tmp_path, kw):
    ours, theirs, ret_ours, ret_theirs = _prep_both(
        tmp_path, prepare, jax_prepare, data_dir=csv_dir, **kw
    )
    _same_artifacts(ours, theirs)
    # The returned (datasets, queries, corpus, relevant docs) agree as well.
    for a, b in zip(ret_ours[2:], ret_theirs[2:]):
        assert a == b and list(a) == list(b)
    assert list(ret_ours[0]["anchor"]) == list(ret_theirs[0]["anchor"])


def test_prep_contracts(csv_dir, tmp_path):
    prep = prepare.InstacartDataPrep(data_dir=csv_dir, output_dir=tmp_path, eval_frac=0.15)
    _, _, queries, corpus, relevant = prep.prepare()
    assert prep.effective_output_dir().name == "p5_mp20_ef0.15"
    assert all(pid in corpus for docs in relevant.values() for pid in docs)
    assert not any("Next:" in q or "next order" in q.lower() for q in queries.values())
    assert all(t.startswith("Product: ") and ". Aisle: " in t for t in corpus.values())


@pytest.mark.parametrize(
    "args", [(float("nan"), 3, 7), (4.0, 0, "09"), (12.0, 6, 23), (30.0, 1, 0.0)]
)
def test_time_prefix_matches_jax(args):
    """A first order (no days_since_prior) renders without ``+Nd``; a string
    hour is kept as it is."""
    assert prepare.InstacartDataPrep._time_prefix(*args) == (
        jax_prepare.InstacartDataPrep._time_prefix(*args)
    )


@pytest.mark.parametrize(
    "text",
    ["[+7d w4h14] Milk, Bread. Next: +7d w4h14", "(no prior orders). Next: w1h9", "no clause"],
)
def test_strip_next_order_matches_jax(text):
    assert prepare.strip_next_order_from_context(text) == (
        jax_prepare.strip_next_order_from_context(text)
    )


def test_cli_writes_what_the_jax_cli_writes(csv_dir, tmp_path, monkeypatch):
    """``python -m ..._torch.data --config`` (its ``main``) against JAX's
    ``main`` on one YAML; the YAML's keys load into the same config."""
    raw = {
        "data_dir": str(csv_dir), "output_dir": str(tmp_path / "processed"),
        "max_prior_orders": 4, "max_product_names": 12, "eval_frac": 0.2, "seed": 9,
    }
    config = tmp_path / "prep.yaml"
    config.write_text("".join(f"{k}: {v}\n" for k, v in raw.items()))
    assert vars(prepare.DataPrepConfig.load(config)) == vars(
        jax_prepare.DataPrepConfig.load(config)
    )
    assert vars(prepare.DataPrepConfig.load(None)) == vars(jax_prepare.DataPrepConfig.load(None))

    monkeypatch.setattr(sys, "argv", ["prepare", "--config", str(config)])
    jax_prepare.main()
    theirs = (tmp_path / "processed").rename(tmp_path / "processed_jax")
    assert prepare.main(["--config", str(config)]) == 0
    name = "p4_mp12_ef0.2"
    _same_artifacts(tmp_path / "processed" / name, theirs / name)
    params = json.loads((tmp_path / "processed" / name / "data_prep_params.json").read_text())
    assert params["seed"] == 9 and params["n_corpus"] == 90
