"""Training batch construction: no-duplicates sampling + fixed-shape batches.

The port's copy of the JAX package's ``data/batching.py`` (numpy only, the
same batches for the same seed): shuffled batches in which no anchor or
positive text repeats (duplicate positives would be false negatives for
MNRL); samples that don't fit wait for a later batch; the final ragged batch
is dropped (sentence-transformers' ``NO_DUPLICATES`` sampler with
``dataloader_drop_last=True``).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def no_duplicates_batches(
    anchors: Sequence[str],
    positives: Sequence[str],
    batch_size: int,
    seed: int,
    epoch: int = 0,
) -> Iterator[np.ndarray]:
    """Yield index arrays of exactly ``batch_size`` (drop_last semantics).

    Scans one permutation through a pointer, with a small ``carry`` list of
    deferred duplicates that are retried first in the next batch: O(N) per
    epoch.
    """
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(len(anchors)).tolist()
    carry: list[int] = []  # deferred duplicates, retried first next batch
    pos = 0
    n = len(order)
    while len(carry) + (n - pos) >= batch_size:
        batch: list[int] = []
        seen: set[str] = set()
        new_carry: list[int] = []
        filled = False
        # Scan order matches the original list-concat formulation exactly:
        # previous batches' deferred duplicates first, then the unconsumed
        # tail of the permutation.
        ci = 0
        while ci < len(carry) and not filled:
            i = carry[ci]
            ci += 1
            a, p = anchors[i], positives[i]
            if a in seen or p in seen:
                new_carry.append(i)
                continue
            batch.append(i)
            seen.add(a)
            seen.add(p)
            filled = len(batch) == batch_size
        while pos < n and not filled:
            i = order[pos]
            pos += 1
            a, p = anchors[i], positives[i]
            if a in seen or p in seen:
                new_carry.append(i)
                continue
            batch.append(i)
            seen.add(a)
            seen.add(p)
            filled = len(batch) == batch_size
        if not filled:
            # Remaining samples cannot fill a clean batch; drop them.
            return
        carry = new_carry + carry[ci:]
        yield np.asarray(batch)


def steps_per_epoch(n_samples: int, batch_size: int) -> int:
    """Upper bound used for LR scheduling (ceil-div; the no-duplicates
    sampler may yield slightly fewer)."""
    return -(-n_samples // batch_size)
