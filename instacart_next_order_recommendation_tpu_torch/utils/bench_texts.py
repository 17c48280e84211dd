"""The serve benchmark's workload: a synthetic product catalog and user-context
queries.

The port's own copy of the JAX repo's ``bench.py`` workload functions
(``CATALOG_SIZE``, ``TOP_K``, ``build_catalog_texts``, ``build_query_texts``):
for one numpy generator state they give the same strings, so a profile or a
soak on the port reads the same texts as one on the JAX package.
"""

from __future__ import annotations

import numpy as np

CATALOG_SIZE = 50_000
TOP_K = 10


def build_catalog_texts(n: int, rng: np.random.Generator) -> list[str]:
    """Product texts in the corpus template ("Product: X. Aisle: Y. Department: Z.")."""
    adjectives = [
        "Organic", "Fresh", "Whole", "Natural", "Classic", "Golden", "Premium",
        "Sweet", "Crunchy", "Creamy", "Roasted", "Smoked", "Wild", "Baked",
    ]
    nouns = [
        "Milk", "Bread", "Banana", "Yogurt", "Cheese", "Chicken", "Broccoli",
        "Rice", "Coffee", "Granola", "Pasta", "Sauce", "Parmesan", "Apple",
    ]
    aisles = ["fresh fruits", "milk", "bread", "cereal", "coffee", "pasta sauce"]
    depts = ["produce", "dairy eggs", "bakery", "beverages", "pantry"]
    out = []
    for i in range(n):
        name = f"{rng.choice(adjectives)} {rng.choice(nouns)} {i}"
        out.append(
            f"Product: {name}. Aisle: {rng.choice(aisles)}. Department: {rng.choice(depts)}."
        )
    return out


def build_query_texts(n: int, catalog: list[str], rng: np.random.Generator) -> list[str]:
    """User-context-shaped queries: [+Nd wDhH] name, name; ... (serve-time form)."""
    names = [t.split("Product: ")[1].split(".")[0] for t in catalog]
    out = []
    for _ in range(n):
        segments = []
        for _ in range(int(rng.integers(1, 6))):
            k = int(rng.integers(2, 7))
            prods = rng.choice(len(names), size=k, replace=False)
            prefix = (
                f"+{int(rng.integers(1, 30))}d w{int(rng.integers(0, 7))}"
                f"h{int(rng.integers(0, 24))}"
            )
            segments.append(f"[{prefix}] " + ", ".join(names[j] for j in prods))
        out.append("; ".join(segments) + ".")
    return out
