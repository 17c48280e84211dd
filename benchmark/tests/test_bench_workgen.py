"""The generator: the same seed gives the same work, another seed other
texts with the same shapes."""

import numpy as np

from benchmark import workgen

SEEDS = (2**31 + 11, 2**31 + 12)


def test_catalog_and_queries_by_seed():
    a = workgen.catalog_texts(200, SEEDS[0])
    assert a == workgen.catalog_texts(200, SEEDS[0])
    assert a != workgen.catalog_texts(200, SEEDS[1])
    q = workgen.query_texts(50, a, SEEDS[0])
    assert q == workgen.query_texts(50, a, SEEDS[0])
    assert q != workgen.query_texts(50, a, SEEDS[1])


def test_query_shapes_are_one_multiset_for_every_seed():
    def shapes(seed):
        cat = workgen.catalog_texts(300, seed)
        return sorted((x.count(";"), x.count(",")) for x in workgen.query_texts(80, cat, seed))

    assert shapes(SEEDS[0]) == shapes(SEEDS[1])


def test_pairs_by_seed():
    def pairs(seed):
        syn = workgen.synthetic_users(40, 60, seed)
        return workgen.training_pairs(syn, 5, 20)

    a = pairs(SEEDS[0])
    assert a == pairs(SEEDS[0])
    assert a != pairs(SEEDS[1])
    anchors, positives = a
    assert len(anchors) == len(positives) > 0
    assert all(" Next: " in x for x in anchors)
    assert all(x.startswith("Product: ") for x in positives)


def test_no_duplicates_batches():
    syn = workgen.synthetic_users(60, 80, SEEDS[0])
    anchors, positives = workgen.training_pairs(syn, 5, 20)
    batches = list(workgen.no_duplicates_batches(anchors, positives, 16, SEEDS[0], 0))
    assert batches and all(len(b) == 16 for b in batches)
    for b in batches:
        texts = [anchors[i] for i in b] + [positives[i] for i in b]
        assert len(set(texts)) == len(texts)
    again = list(workgen.no_duplicates_batches(anchors, positives, 16, SEEDS[0], 0))
    assert all(np.array_equal(x, y) for x, y in zip(batches, again))


def test_vocab_training():
    texts = workgen.catalog_texts(200, SEEDS[0])
    v = workgen.train_vocab(texts, 500)
    assert list(v)[:5] == workgen.SPECIAL_TOKENS
    assert len(v) <= 500 and v == workgen.train_vocab(texts, 500)
    assert "product" in v and "##7" in v


def test_arrivals_are_one_multiset_of_gaps_in_a_seeded_order():
    a = workgen.arrival_times(28.0, 20.0, SEEDS[0])
    b = workgen.arrival_times(28.0, 20.0, SEEDS[1])
    assert len(a) == len(b) == 560
    assert a[0] == 0.0 and a[-1] < 20.0 and np.all(np.diff(a) > 0)
    assert np.allclose(np.sort(np.diff(a, append=20.0)), np.sort(np.diff(b, append=20.0)))
    assert not np.allclose(a, b)
    assert np.array_equal(a, workgen.arrival_times(28.0, 20.0, SEEDS[0]))
    # The gaps are exponential: their coefficient of variation is near 1.
    gaps = np.diff(a)
    assert 0.85 < gaps.std() / gaps.mean() < 1.15


def test_bucket_length():
    assert workgen.bucket_length(150, 256) == 160
    assert workgen.bucket_length(250, 256) == 256
    assert workgen.bucket_length(300, 256) == 256
