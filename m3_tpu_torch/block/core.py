"""Block model: tags, the step grid and per-series metadata.

A copy of ``m3_tpu/block/core.py`` (``Tags``, ``make_tags``, ``Bounds``,
``SeriesMeta``): plain Python, kept here so the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

NANOS = 1_000_000_000

# Tags are tuples of (name, value) bytes pairs, sorted by name — the
# hashable, order-canonical equivalent of models.Tags
# (M3's src/query/models/tags.go).
Tags = tuple[tuple[bytes, bytes], ...]


def make_tags(d: dict[bytes | str, bytes | str] | Sequence[tuple]) -> Tags:
    items = d.items() if isinstance(d, dict) else d
    out = []
    for k, v in items:
        k = k.encode() if isinstance(k, str) else bytes(k)
        v = v.encode() if isinstance(v, str) else bytes(v)
        out.append((k, v))
    return tuple(sorted(out))


@dataclass(frozen=True)
class Bounds:
    """Regular step grid: [start, start + step*steps) — query/block/types.go
    Bounds{Start, Duration, StepSize}."""

    start_nanos: int
    step_nanos: int
    steps: int

    @property
    def step_seconds(self) -> float:
        return self.step_nanos / NANOS

    def timestamps(self) -> np.ndarray:
        return self.start_nanos + self.step_nanos * np.arange(self.steps, dtype=np.int64)

    @property
    def end_nanos(self) -> int:
        return self.start_nanos + self.step_nanos * self.steps


@dataclass(frozen=True)
class SeriesMeta:
    """Per-series metadata (block.SeriesMeta: name + tags)."""

    tags: Tags
    name: bytes = b""
