"""The one traffic generator: texts, users, pairs, vocab, batches, arrivals.

Copies, frozen here, of the program's generators, so that a change to the
program cannot change the work it is measured on:

- the catalog and query texts of the serve benchmark (the port's
  ``utils/bench_texts.py``);
- the synthetic Instacart users and the data prep's p5_mp20 pairs
  (``chip_smoke.py``'s ``synthetic_users`` and ``build_training_data``);
- the WordPiece vocab trainer and BERT's basic tokenization of ASCII text
  (``tokenizer/wordpiece.py``);
- the no-duplicates batch sampler (``data/batching.py``).

Every function takes its randomness from a ``--seed``. Where the work of a
run depends on shapes (how many segments a query has, how far apart calls
arrive), the shapes are one fixed multiset for every seed, which the seed
only reorders and fills with other products, so two seeds do the same
amount of work.
"""

from __future__ import annotations

import collections
import math
import re

import numpy as np

SHAPE_SEED = 20_261_018  # the fixed multiset of query shapes and arrival gaps

# ----------------------------------------------------------- serve texts

CATALOG_ADJECTIVES = [
    "Organic", "Fresh", "Whole", "Natural", "Classic", "Golden", "Premium",
    "Sweet", "Crunchy", "Creamy", "Roasted", "Smoked", "Wild", "Baked",
]
CATALOG_NOUNS = [
    "Milk", "Bread", "Banana", "Yogurt", "Cheese", "Chicken", "Broccoli",
    "Rice", "Coffee", "Granola", "Pasta", "Sauce", "Parmesan", "Apple",
]
CATALOG_AISLES = ["fresh fruits", "milk", "bread", "cereal", "coffee", "pasta sauce"]
CATALOG_DEPTS = ["produce", "dairy eggs", "bakery", "beverages", "pantry"]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per purpose, from any whole-number seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def catalog_texts(n: int, seed: int) -> list[str]:
    """Product texts in the corpus template ("Product: X. Aisle: Y.
    Department: Z."), product i named "<adjective> <noun> i"."""
    rng = rng_for(seed, 1)
    adj = rng.integers(0, len(CATALOG_ADJECTIVES), n)
    noun = rng.integers(0, len(CATALOG_NOUNS), n)
    aisle = rng.integers(0, len(CATALOG_AISLES), n)
    dept = rng.integers(0, len(CATALOG_DEPTS), n)
    return [
        f"Product: {CATALOG_ADJECTIVES[adj[i]]} {CATALOG_NOUNS[noun[i]]} {i}. "
        f"Aisle: {CATALOG_AISLES[aisle[i]]}. Department: {CATALOG_DEPTS[dept[i]]}."
        for i in range(n)
    ]


def query_texts(n: int, catalog: list[str], seed: int) -> list[str]:
    """User-context queries in the serve-time form ``[+Nd wDhH] name, name;
    ...``: 1-5 segments of 2-6 products each. The segment counts, product
    counts and time tags are one fixed multiset (``SHAPE_SEED``); the seed
    picks the products and the order of the queries."""
    names = [t.split("Product: ")[1].split(". Aisle")[0] for t in catalog]
    shapes = np.random.default_rng(SHAPE_SEED)
    rng = rng_for(seed, 2)
    out = []
    for _ in range(n):
        segments = []
        for _ in range(int(shapes.integers(1, 6))):
            k = int(shapes.integers(2, 7))
            prefix = (
                f"+{int(shapes.integers(1, 30))}d w{int(shapes.integers(0, 7))}"
                f"h{int(shapes.integers(0, 24))}"
            )
            prods = rng.choice(len(names), size=k, replace=False)
            segments.append(f"[{prefix}] " + ", ".join(names[j] for j in prods))
        out.append("; ".join(segments) + ".")
    order = rng.permutation(n)
    return [out[i] for i in order]


# ----------------------------------------------------------- training pairs

AISLES = [
    "fresh fruits", "fresh vegetables", "packaged cheese", "milk", "yogurt",
    "bread", "cereal", "coffee", "pasta sauce", "frozen meals", "soy lactosefree",
    "baking ingredients", "canned meals beans", "eggs", "juice nectars",
]
DEPARTMENTS = [
    "produce", "dairy eggs", "bakery", "beverages", "pantry", "frozen",
    "canned goods", "breakfast", "snacks", "meat seafood",
]
ADJECTIVES = [
    "Organic", "Fresh", "Whole", "Natural", "Classic", "Golden", "Premium",
    "Sweet", "Crunchy", "Creamy", "Roasted", "Smoked", "Wild", "Baked", "Frozen",
    "Spicy", "Zesty", "Light", "Dark", "Honey",
]
NOUNS = [
    "Milk", "Bread", "Banana", "Yogurt", "Cheese", "Chicken", "Broccoli",
    "Rice", "Coffee", "Granola", "Pasta", "Sauce", "Parmesan", "Apple",
    "Spinach", "Salmon", "Beans", "Cereal", "Juice", "Butter", "Eggs",
    "Tortilla", "Hummus", "Avocado", "Berries", "Oats", "Tea", "Chocolate",
    "Crackers", "Soup",
]
NAME_MODIFIERS = [
    "Gluten-Free", "Low-Fat", "Unsweetened", "Family Size", "Extra Crunchy",
    "Non-GMO", "Grass-Fed", "Cage-Free", "Stone-Ground", "Small Batch",
    "Reduced Sodium", "No Sugar Added", "Single Origin", "Double Churned",
]
NAME_EXTRAS = [
    "with Honey & Flax", "with Sea Salt", "in Olive Oil", "with Real Fruit",
    "with Ancient Grains", "with Whole Berries", "in Tomato Basil Sauce",
    "with Roasted Garlic", "with Dark Chocolate Chips", "with Almond Butter",
]
NAME_UNITS = [
    "12 oz", "1 Gallon", "6 Pack", "500 g", "2 lb Bag", "16.9 fl oz",
    "Variety Pack of 8", "32 oz Tub", "10 ct Box", "750 ml",
]


def _time_prefix(days: int | None, dow: int, hour: int) -> str:
    return f"w{dow}h{hour}" if days is None else f"+{days}d w{dow}h{hour}"


def synthetic_users(n_users: int, n_products: int, seed: int) -> dict:
    """Synthetic Instacart users over products with real-length names (6-10
    words): ``catalog`` (product i's text), ``names`` and each user's 4-8
    orders, oldest first, as (days since the prior order or None, day of
    week, hour, basket of product indices). Each user prefers three aisles
    and reorders about 60% of each basket."""
    rng = rng_for(seed, 3)
    n_aisles = len(AISLES)
    per_aisle = len(NOUNS) // n_aisles
    aisle = rng.integers(0, n_aisles, size=n_products)
    aisle_dept = rng.integers(0, len(DEPARTMENTS), size=n_aisles)
    names: list[str] = []
    seen: set[str] = set()
    for i, a in enumerate(aisle):
        noun = NOUNS[a * per_aisle + int(rng.integers(0, per_aisle))]
        name = (
            f"{rng.choice(NAME_MODIFIERS)} {rng.choice(ADJECTIVES)} {noun} "
            f"{rng.choice(NAME_EXTRAS)}, {rng.choice(NAME_UNITS)}"
        )
        name = f"{name} No {i}" if name in seen else name
        seen.add(name)
        names.append(name)
    catalog = [
        f"Product: {n}. Aisle: {AISLES[a]}. Department: {DEPARTMENTS[aisle_dept[a]]}."
        for n, a in zip(names, aisle)
    ]
    by_aisle = [np.flatnonzero(aisle == a) for a in range(n_aisles)]
    users = []
    for _ in range(n_users):
        pref = np.concatenate([by_aisle[a] for a in rng.choice(n_aisles, 3, replace=False)])
        bought: list[int] = []
        orders = []
        for o in range(int(rng.integers(4, 9))):
            days = None if o == 0 else int(rng.integers(1, 30))
            dow, hour = int(rng.integers(0, 7)), int(rng.integers(0, 24))
            n_items = int(rng.integers(3, 10))
            n_re = min(int(round(n_items * 0.6)), len(bought))
            basket = [int(p) for p in rng.choice(bought, size=n_re, replace=False)] if n_re else []
            n_new = n_items - n_re
            n_pref = min(max(1, int(round(n_new * 0.8))), len(pref)) if n_new else 0
            basket += [int(p) for p in rng.choice(pref, size=n_pref, replace=False)]
            basket += [int(p) for p in rng.choice(n_products, size=n_new - n_pref, replace=False)]
            basket = list(dict.fromkeys(basket))
            orders.append((days, dow, hour, basket))
            bought = list(dict.fromkeys(bought + basket))
        users.append(orders)
    return {"catalog": catalog, "names": names, "users": users}


def training_pairs(
    synthetic: dict, max_prior_orders: int, max_product_names: int
) -> tuple[list[str], list[str]]:
    """(anchors, positives) in the data prep's form: an anchor is a user's
    context before the last order (the last ``max_prior_orders`` prior
    orders, oldest first, at most ``max_product_names`` names, then ``Next:
    <time>``), a positive one product text of that order, one pair per
    product."""
    catalog, names = synthetic["catalog"], synthetic["names"]
    anchors, positives = [], []
    for orders in synthetic["users"]:
        segments, total = [], 0
        for days, dow, hour, basket in orders[-1 - max_prior_orders : -1]:
            take = basket[: max_product_names - total]
            if not take:
                break
            total += len(take)
            segments.append(
                f"[{_time_prefix(days, dow, hour)}] " + ", ".join(names[p] for p in take)
            )
        days, dow, hour, basket = orders[-1]
        context = "; ".join(segments) + ". Next: " + _time_prefix(days, dow, hour)
        for p in basket:
            anchors.append(context)
            positives.append(catalog[p])
    return anchors, positives


LENGTH_BUCKETS = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 512)


def bucket_length(longest: int, max_seq_length: int) -> int:
    """The trainer's one global pad length: the smallest length bucket that
    holds the longest tokenized text, at most ``max_seq_length``."""
    for b in LENGTH_BUCKETS:
        if b >= min(longest, max_seq_length):
            return min(b, max_seq_length)
    return max_seq_length


def no_duplicates_batches(
    anchors: list[str], positives: list[str], batch_size: int, seed: int, epoch: int
):
    """Index arrays of exactly ``batch_size`` in which no anchor or positive
    text repeats (a repeat would be a false negative for MNRL); samples that
    do not fit wait for a later batch; the ragged end is dropped."""
    rng = rng_for(seed, 1000 + epoch)
    order = rng.permutation(len(anchors)).tolist()
    carry: list[int] = []
    pos, n = 0, len(order)
    while len(carry) + (n - pos) >= batch_size:
        batch: list[int] = []
        seen: set[str] = set()
        new_carry: list[int] = []
        ci = 0
        while ci < len(carry) and len(batch) < batch_size:
            i = carry[ci]
            ci += 1
            if anchors[i] in seen or positives[i] in seen:
                new_carry.append(i)
                continue
            batch.append(i)
            seen.update((anchors[i], positives[i]))
        while pos < n and len(batch) < batch_size:
            i = order[pos]
            pos += 1
            if anchors[i] in seen or positives[i] in seen:
                new_carry.append(i)
                continue
            batch.append(i)
            seen.update((anchors[i], positives[i]))
        if len(batch) < batch_size:
            return
        carry = new_carry + carry[ci:]
        yield np.asarray(batch)


# ----------------------------------------------------------- vocab

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
_ASCII_CONTROLS = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
_ASCII_TOKENS = re.compile(r"[0-9A-Za-z]+|[!-/:-@\[-`{-~]")


def ascii_words(text: str) -> list[str]:
    """BERT's basic tokenization of lower-cased ASCII text: runs of letters
    and digits, and single punctuation characters."""
    if not text.isascii():
        raise ValueError("the generator makes ASCII text only")
    return _ASCII_TOKENS.findall(_ASCII_CONTROLS.sub("", text).lower())


def train_vocab(texts, vocab_size: int, min_frequency: int = 2) -> dict[str, int]:
    """A WordPiece vocab induced from the texts: the specials, every
    character seen (word-initial and ``##`` forms, with all ASCII letters
    and digits), then the most frequent whole words, then the most frequent
    2-4 character continuations, up to ``vocab_size``."""
    word_freq: collections.Counter[str] = collections.Counter()
    for text in texts:
        word_freq.update(ascii_words(text))
    base = "abcdefghijklmnopqrstuvwxyz0123456789"
    chars = {c for c in base} | {f"##{c}" for c in base}
    for word in word_freq:
        for i, ch in enumerate(word):
            chars.add(ch if i == 0 else f"##{ch}")
    suffix_freq: collections.Counter[str] = collections.Counter()
    for word, freq in word_freq.items():
        for start in range(1, len(word)):
            for ln in (2, 3, 4):
                if start + ln <= len(word):
                    suffix_freq[f"##{word[start:start + ln]}"] += freq
    vocab: dict[str, int] = {}
    for tok in SPECIAL_TOKENS:
        vocab[tok] = len(vocab)
    for tok in sorted(chars):
        vocab.setdefault(tok, len(vocab))
    for word, freq in word_freq.most_common():
        if len(vocab) >= vocab_size:
            break
        if freq >= min_frequency and word not in vocab:
            vocab[word] = len(vocab)
    for piece, freq in suffix_freq.most_common():
        if len(vocab) >= vocab_size:
            break
        if freq >= min_frequency and piece not in vocab:
            vocab[piece] = len(vocab)
    return vocab


# ----------------------------------------------------------- arrivals


def arrival_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of n = floor(rate x seconds)
    calls of a Poisson stream: the gaps are the exponential distribution's
    quantiles at (i + 0.5) / n, scaled to sum to ``seconds``, one fixed
    multiset in an order the seed shuffles. The first call is due at 0 and
    every call is due inside the window, so every seed has the same n."""
    n = max(1, int(math.floor(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    rng = rng_for(seed, 4)
    gaps = gaps[rng.permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])
