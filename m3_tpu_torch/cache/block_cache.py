"""Identity of one sealed, immutable block of one series.

The ``BlockKey`` of ``m3_tpu/cache/block_cache.py``: the resident pool's
page table is keyed by it. The decoded-block cache itself is not ported.
"""

from __future__ import annotations

from typing import NamedTuple


class BlockKey(NamedTuple):
    """(namespace, shard, series, block_start, volume)."""

    namespace: str
    shard_id: int
    series_id: bytes
    block_start: int
    volume: int

    @property
    def series_key(self) -> tuple:
        return (self.namespace, self.shard_id, self.series_id, self.block_start)

    @property
    def block_key(self) -> tuple:
        return (self.namespace, self.shard_id, self.block_start)
