"""The one generator of the benchmark's traffic.

A traffic mix is a data file, ``traffic/<name>.json``:

- ``entry``: the program's entry point a call drives (``align_score``,
  ``align`` or ``align_score_batch``, see ``harness.ENTRIES``);
- ``pairs``: pairs a call (1 for the single-pair entries);
- ``text``, ``query``: ``[lo, hi]``, the law of the text (columns) and query
  (rows) lengths, uniform and independent;
- ``pool``: inputs made at set-up; calls take them in turn, so no call sees
  its predecessor's input.

The shapes of a call are the same for every seed: the lengths are the law's
``pairs`` quantiles, the query lengths permuted by a fixed ``PAIRING``.  The seed
orders the pairs and draws the codes (uniform over the configuration's
``alphabet``), so two seeds do the same work on other data.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

#: the seed of the fixed permutation that pairs query lengths with text
#: lengths, the same for every mix and every run
PAIRING = 0


@dataclasses.dataclass(frozen=True)
class Input:
    """One call's pairs: ``texts[p]`` across the columns, ``queries[p]`` down
    the rows, int8 codes."""

    texts: List[np.ndarray]
    queries: List[np.ndarray]

    @property
    def cells(self) -> int:
        """DP cells of the call, the sum of m * n."""
        return sum(t.size * q.size for t, q in zip(self.texts, self.queries))


def _quantiles(lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` lengths at the mid-points of equal strata of the uniform
    law on ``lo..hi``."""
    return lo + ((np.arange(count) + 0.5) * (hi - lo + 1) / count).astype(np.int64)


def shapes(traffic: dict) -> np.ndarray:
    """``(pairs, 2)``: a call's (text, query) lengths, before the seed's
    order."""
    count = int(traffic["pairs"])
    m = _quantiles(*traffic["text"], count)
    n = _quantiles(*traffic["query"], count)
    n = n[np.random.default_rng(PAIRING).permutation(count)]
    return np.stack([m, n], axis=1)


def make_pool(traffic: dict, config: dict, seed: int) -> List[Input]:
    """The pool of ``traffic["pool"]`` inputs of ``seed``, any whole number."""
    gen = np.random.default_rng(seed % (1 << 64))
    lo, hi = config["alphabet"]
    base = shapes(traffic)
    pool = []
    for _ in range(int(traffic["pool"])):
        mn = base[gen.permutation(len(base))]
        texts = gen.integers(lo, hi + 1, size=int(mn[:, 0].sum()), dtype=np.int8)
        queries = gen.integers(lo, hi + 1, size=int(mn[:, 1].sum()), dtype=np.int8)
        pool.append(Input(np.split(texts, np.cumsum(mn[:, 0])[:-1]),
                          np.split(queries, np.cumsum(mn[:, 1])[:-1])))
    return pool
