"""The one traffic generator: every mix is a file of parameters it reads.

A seed changes the order of the work, never its amount: the prompt
lengths are a fixed set of quantiles of the mix's clipped log-normal,
dealt out in an order drawn from the seed, and the arrival gaps of a rate
mix (Poisson) are a fixed set of exponential quantiles in a seeded order.
So every seed offers the same lengths and the same number of arrivals in
each period, and runs with different seeds differ as little as two runs
of one seed.  Token ids are uniform over the vocabulary, drawn from the seed.
"""

from __future__ import annotations

import json
import math
from statistics import NormalDist

import numpy as np

LENGTH_STREAM, IDS_STREAM, ARRIVAL_STREAM, SAMPLE_STREAM = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of one seed (any integer)."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def length_set(prompt: dict) -> np.ndarray:
    """``set_size`` quantiles of the log-normal (``median``, ``sigma``),
    rounded and clipped to ``[min, max]``."""
    n = int(prompt["set_size"])
    z = [NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    lengths = np.round(prompt["median"] * np.exp(prompt["sigma"] * np.array(z)))
    return np.clip(lengths, prompt["min"], prompt["max"]).astype(np.int64)


class Prompts:
    """The mix's prompts in order: message ``i`` takes the next length of a
    seeded permutation of :func:`length_set` (a fresh permutation every
    ``set_size`` messages) and that many seeded token ids."""

    def __init__(self, prompt: dict, seed: int, vocab: int) -> None:
        self._set = length_set(prompt)
        self._order = rng(seed, LENGTH_STREAM)
        self._ids = rng(seed, IDS_STREAM)
        self._vocab = vocab
        self._lengths: list[int] = []
        self._next = 0

    def length(self, i: int) -> int:
        while len(self._lengths) <= i:
            self._lengths.extend(self._order.permutation(self._set).tolist())
        return self._lengths[i]

    def take(self, count: int) -> list[np.ndarray]:
        """The next ``count`` prompts' ids."""
        start, self._next = self._next, self._next + count
        return [self._ids.integers(0, self._vocab, size=self.length(i),
                                   dtype=np.int64)
                for i in range(start, start + count)]


def body(ids: np.ndarray) -> str:
    """A message body: the JSON array of token ids the worker parses."""
    return json.dumps(ids.tolist())


def _segment(start: float, length: float, count: int,
             order: np.random.Generator) -> list[float]:
    """``count`` arrival times in ``[start, start + length)``: the gaps are
    ``count + 1`` exponential quantiles in a seeded order, scaled to fill
    the segment."""
    if count <= 0:
        return []
    gaps = np.array([-math.log(1 - (k + 0.5) / (count + 1))
                     for k in range(count + 1)])
    gaps = order.permutation(gaps)
    times = np.cumsum(gaps[:-1]) / gaps.sum() * length
    return (start + times).tolist()


def arrivals(rate: dict, seed: int, start: float, end: float) -> list[float]:
    """Arrival offsets in ``[start, end)`` of a rate mix: ``per_s`` on
    average, the same count, ``per_s * period_s``, in every ``period_s``.
    ``start`` is a whole number of periods."""
    period = float(rate["period_s"])
    count = round(rate["per_s"] * period)
    order = rng(seed, ARRIVAL_STREAM)
    out: list[float] = []
    t = start
    while t < end:
        out += _segment(t, period, count, order)
        t += period
    return [a for a in out if a < end]
