"""Synthetic Instacart-schema data generator.

The port's copy of the JAX package's ``data/synthetic.py``: for the same
arguments it writes byte-identical CSVs. It produces the six Kaggle CSVs
(products/aisles/departments/orders/order_products__{prior,train}) with a
learnable structure: each user is assigned a small set of preferred aisles
and draws basket products mostly from them, so a two-tower model trained on
the generated pairs genuinely improves Recall@k over an untrained tower.
Used by the demo, the workflows' tests and ``chip_smoke.py`` (the real
dataset is not redistributable).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

_ADJECTIVES = [
    "Organic", "Fresh", "Whole", "Natural", "Classic", "Golden", "Premium",
    "Sweet", "Crunchy", "Creamy", "Roasted", "Smoked", "Wild", "Baked", "Frozen",
    "Spicy", "Zesty", "Light", "Dark", "Honey",
]
_NOUNS = [
    "Milk", "Bread", "Banana", "Yogurt", "Cheese", "Chicken", "Broccoli",
    "Rice", "Coffee", "Granola", "Pasta", "Sauce", "Parmesan", "Apple",
    "Spinach", "Salmon", "Beans", "Cereal", "Juice", "Butter", "Eggs",
    "Tortilla", "Hummus", "Avocado", "Berries", "Oats", "Tea", "Chocolate",
    "Crackers", "Soup",
]
_AISLES = [
    "fresh fruits", "fresh vegetables", "packaged cheese", "milk", "yogurt",
    "bread", "cereal", "coffee", "pasta sauce", "frozen meals", "soy lactosefree",
    "baking ingredients", "canned meals beans", "eggs", "juice nectars",
]
_DEPARTMENTS = [
    "produce", "dairy eggs", "bakery", "beverages", "pantry", "frozen",
    "canned goods", "breakfast", "snacks", "meat seafood",
]

# ``long_names=True`` vocabulary: real Instacart product names run 6-10
# words ("Organic Whole Wheat Bread with Honey & Flax, Family Size, 24 oz"),
# which is why the reference's p5_mp20 prep genuinely fills max_seq_length
# 256 on the real CSVs. Short two-word synthetic names cap contexts at
# ~90 tokens no matter the basket depth, so shape rehearsals of the real
# recipe need name geometry, not just more products per order.
_NAME_MODIFIERS = [
    "Gluten-Free", "Low-Fat", "Unsweetened", "Family Size", "Extra Crunchy",
    "Non-GMO", "Grass-Fed", "Cage-Free", "Stone-Ground", "Small Batch",
    "Reduced Sodium", "No Sugar Added", "Single Origin", "Double Churned",
]
_NAME_EXTRAS = [
    "with Honey & Flax", "with Sea Salt", "in Olive Oil", "with Real Fruit",
    "with Ancient Grains", "with Whole Berries", "in Tomato Basil Sauce",
    "with Roasted Garlic", "with Dark Chocolate Chips", "with Almond Butter",
]
_NAME_UNITS = [
    "12 oz", "1 Gallon", "6 Pack", "500 g", "2 lb Bag", "16.9 fl oz",
    "Variety Pack of 8", "32 oz Tub", "10 ct Box", "750 ml",
]


def generate_instacart_csvs(
    data_dir: Path | str,
    n_users: int = 200,
    n_products: int = 400,
    orders_per_user: tuple[int, int] = (4, 9),
    basket_size: tuple[int, int] = (3, 10),
    aisles_per_user: int = 3,
    reorder_rate: float = 0.6,
    seed: int = 0,
    long_names: bool = False,
) -> Path:
    """Write synthetic CSVs to ``data_dir``; returns the dir."""
    rng = np.random.default_rng(seed)
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)

    n_aisles = len(_AISLES)
    n_depts = len(_DEPARTMENTS)
    aisles = pd.DataFrame({"aisle_id": np.arange(1, n_aisles + 1), "aisle": _AISLES})
    departments = pd.DataFrame(
        {"department_id": np.arange(1, n_depts + 1), "department": _DEPARTMENTS}
    )

    # Names correlate with aisles (each aisle owns a few theme nouns), like
    # real grocery data — this is the signal a two-tower model generalizes
    # from, so trained recall genuinely beats untrained on generated data.
    nouns_per_aisle = max(1, len(_NOUNS) // n_aisles)
    aisle_nouns = {
        a: _NOUNS[(a - 1) * nouns_per_aisle : (a - 1) * nouns_per_aisle + nouns_per_aisle]
        or _NOUNS
        for a in range(1, n_aisles + 1)
    }
    product_aisle = rng.integers(1, n_aisles + 1, size=n_products)
    names = []
    seen: set[str] = set()
    for i in range(n_products):
        pool = aisle_nouns[int(product_aisle[i])]
        name = f"{rng.choice(_ADJECTIVES)} {pool[int(rng.integers(0, len(pool)))]}"
        if long_names:
            # Real-name geometry: base stays aisle-themed (the learnable
            # signal), the rest matches real catalog verbosity.
            name = (
                f"{rng.choice(_NAME_MODIFIERS)} {name} "
                f"{rng.choice(_NAME_EXTRAS)}, {rng.choice(_NAME_UNITS)}"
            )
        if name in seen:
            name = f"{name} {len(names)}" if not long_names else f"{name} No {len(names)}"
        seen.add(name)
        names.append(name)
    aisle_to_dept = rng.integers(1, n_depts + 1, size=n_aisles + 1)
    products = pd.DataFrame(
        {
            "product_id": np.arange(1, n_products + 1),
            "product_name": names,
            "aisle_id": product_aisle,
            "department_id": aisle_to_dept[product_aisle],
        }
    )

    # Aisle-affinity structure: products grouped by aisle, users prefer a few.
    aisle_products = {
        a: products.loc[products["aisle_id"] == a, "product_id"].to_numpy()
        for a in range(1, n_aisles + 1)
    }

    orders_rows = []
    prior_rows = []
    train_rows = []
    order_id = 0
    for user_id in range(1, n_users + 1):
        pref = rng.choice(np.arange(1, n_aisles + 1), size=aisles_per_user, replace=False)
        pref_pool = np.concatenate([aisle_products[a] for a in pref if len(aisle_products[a])])
        if len(pref_pool) == 0:
            pref_pool = products["product_id"].to_numpy()
        n_orders = int(rng.integers(*orders_per_user))
        bought: set[int] = set()
        for order_number in range(1, n_orders + 1):
            order_id += 1
            is_last = order_number == n_orders
            days = np.nan if order_number == 1 else float(rng.integers(1, 30))
            orders_rows.append(
                {
                    "order_id": order_id,
                    "user_id": user_id,
                    "eval_set": "train" if is_last else "prior",
                    "order_number": order_number,
                    "order_dow": int(rng.integers(0, 7)),
                    "order_hour_of_day": int(rng.integers(0, 24)),
                    "days_since_prior_order": days,
                }
            )
            n_items = int(rng.integers(*basket_size))
            # Real Instacart behavior: most items are REORDERS of products the
            # user bought before (~59% in the real data). This is the dominant
            # signal the two-tower model learns (context names literally
            # contain many next-order products).
            n_reorder = (
                int(round(n_items * reorder_rate)) if len(bought) else 0
            )
            n_reorder = min(n_reorder, len(bought))
            reordered_ids = (
                rng.choice(np.fromiter(bought, dtype=np.int64), size=n_reorder, replace=False)
                if n_reorder
                else np.array([], dtype=np.int64)
            )
            n_new = n_items - n_reorder
            n_new_pref = max(1, int(round(n_new * 0.8))) if n_new > 0 else 0
            new_pref = rng.choice(
                pref_pool, size=min(n_new_pref, len(pref_pool)), replace=False
            )
            n_rand = max(0, n_new - len(new_pref))
            new_rand = rng.choice(
                products["product_id"].to_numpy(), size=n_rand, replace=False
            )
            basket = pd.unique(np.concatenate([reordered_ids, new_pref, new_rand]))
            target = train_rows if is_last else prior_rows
            for pos, pid in enumerate(basket, start=1):
                target.append(
                    {
                        "order_id": order_id,
                        "product_id": int(pid),
                        "add_to_cart_order": pos,
                        "reordered": int(int(pid) in bought),
                    }
                )
                bought.add(int(pid))

    products.to_csv(data_dir / "products.csv", index=False)
    aisles.to_csv(data_dir / "aisles.csv", index=False)
    departments.to_csv(data_dir / "departments.csv", index=False)
    pd.DataFrame(orders_rows).to_csv(data_dir / "orders.csv", index=False)
    pd.DataFrame(prior_rows).to_csv(data_dir / "order_products__prior.csv", index=False)
    pd.DataFrame(train_rows).to_csv(data_dir / "order_products__train.csv", index=False)
    return data_dir
