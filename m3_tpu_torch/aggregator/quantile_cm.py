"""Cormode–Muthukrishnan targeted-quantile stream (host-side).

A copy of ``m3_tpu/aggregator/quantile_cm.py`` (host Python).

Reference: M3's src/aggregator/aggregation/quantile/cm/stream.go
(statsite-derived biased-quantiles sketch). The device aggregation path
(kernels.py) computes EXACT quantiles of whole windows on the card (kernel
B-5b) — strictly more accurate and the framework default — but the streaming sketch
matters where windows never materialize (host-side forwarding stages,
collector pre-aggregation), so the reference's component exists here with
the same contract: targeted quantiles with per-target error eps.

Algorithm (Cormode & Muthukrishnan, "Effective Computation of Biased
Quantiles over Data Streams"): a sorted list of (value, g, delta) samples;
inserts buffer and merge in sorted order; compress() merges adjacent
samples whose combined weight stays within the invariant f(r, n); query(q)
walks cumulative weights to the first sample crossing the target rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class _Sample:
    value: float
    g: int  # rank gap to the previous sample
    delta: int  # rank uncertainty


class QuantileStream:
    """Targeted quantiles: quantiles q with error eps on each target.

    insert() amortizes through a buffer; samples stay O((1/eps) log(eps n)).
    """

    def __init__(self, quantiles=(0.5, 0.95, 0.99), eps: float = 0.01,
                 buffer_size: int = 512) -> None:
        if not quantiles:
            raise ValueError("need at least one target quantile")
        self.targets = tuple(sorted(float(q) for q in quantiles))
        if any(q <= 0.0 or q >= 1.0 for q in self.targets):
            raise ValueError("quantiles must be in (0, 1)")
        self.eps = eps
        self._samples: list[_Sample] = []
        self._buffer: list[float] = []
        self._buffer_size = buffer_size
        self.n = 0

    # invariant f(r, n): allowed weight span for a sample at rank r
    def _invariant(self, r: float, n: int) -> float:
        out = math.inf
        for q in self.targets:
            if r < q * n:
                err = 2 * self.eps * (n - r) / (1 - q)
            else:
                err = 2 * self.eps * r / q
            out = min(out, err)
        return max(out, 1.0)

    def insert(self, value: float) -> None:
        self._buffer.append(float(value))
        if len(self._buffer) >= self._buffer_size:
            self._flush_buffer()

    def _flush_buffer(self) -> None:
        if not self._buffer:
            return
        self._buffer.sort()
        samples = self._samples
        idx = 0
        for v in self._buffer:
            while idx < len(samples) and samples[idx].value <= v:
                idx += 1
            if idx == 0 or idx == len(samples):
                delta = 0
            else:
                # stream.go insert(): delta = successor.numRanks +
                # successor.delta - 1. Neighbor-based (not invariant-based)
                # deltas keep freshly inserted regions mergeable — with
                # invariant-based deltas a monotone stream's sketch
                # degenerates to a near-full buffer.
                nxt = samples[idx]
                delta = nxt.g + nxt.delta - 1
            samples.insert(idx, _Sample(v, 1, max(delta, 0)))
            idx += 1
            self.n += 1
        self._buffer.clear()
        self._compress()

    def _compress(self) -> None:
        # Back-to-front merge pass, mirroring the reference's compress cursor
        # (stream.go walks from the tail maintaining exact minRank). Merging
        # s[i] into its successor cascades naturally on monotone streams, and
        # the rank used for the invariant is the sample's true pre-merge
        # minRank — no double counting of absorbed weight.
        samples = self._samples
        if len(samples) < 3:
            return
        ranks = []  # ranks[i] = exact cumulative g through samples[i]
        acc = 0
        for s in samples:
            acc += s.g
            ranks.append(acc)
        out_rev = [samples[-1]]
        for i in range(len(samples) - 2, 0, -1):
            s = samples[i]
            nxt = out_rev[-1]
            max_rank = ranks[i] + s.delta  # stream.go compress(): maxRank
            if s.g + nxt.g + nxt.delta <= self._invariant(max_rank, self.n):
                nxt.g += s.g
            else:
                out_rev.append(s)
        out_rev.append(samples[0])
        self._samples = out_rev[::-1]

    def query(self, q: float) -> float:
        self._flush_buffer()
        samples = self._samples
        if not samples:
            return math.nan
        if len(samples) == 1:
            return samples[0].value
        target = q * self.n + self._invariant(q * self.n, self.n) / 2
        r = 0.0
        for i in range(1, len(samples)):
            r += samples[i - 1].g
            if r + samples[i].g + samples[i].delta > target:
                return samples[i - 1].value
        return samples[-1].value

    def flush(self) -> None:
        self._flush_buffer()

    @property
    def num_samples(self) -> int:
        return len(self._samples) + len(self._buffer)

    def min(self) -> float:
        self._flush_buffer()
        return self._samples[0].value if self._samples else math.nan

    def max(self) -> float:
        self._flush_buffer()
        return self._samples[-1].value if self._samples else math.nan
