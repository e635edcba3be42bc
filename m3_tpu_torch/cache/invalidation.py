"""Invalidation hooks: mutable/buffered data is never served stale.

A copy of ``m3_tpu/cache/invalidation.py`` (its repair hook waits for the
repair plane, ROADMAP §A10).

Contract (mirrors M3's immutable-fileset model): the ONLY cacheable unit
is a sealed fileset block — buffers never enter the cache, and the read
path always overlays live buffer data on top of cached arrays (newest
wins). That makes the fileset entries correct by construction; these
hooks exist to (a) keep the contract airtight when buffered state for a
cached block changes (write/repair → conservative drop), (b) reclaim
bytes for entries that can never hit again (cold-flush supersession —
persist/fs/merger.go writes a NEW volume; tick expiry deletes filesets
past retention — shard.go:663 tickAndExpire), and (c) give operators a
full flush (clear).

The SAME hooks drive every resident tier: the decoded-block cache
(block_cache.py) and the HBM-resident compressed pool
(resident/pool.py) expose the same targeted-invalidation surface
(invalidate_series_block / invalidate_block / clear), so one hook call
keeps both coherent — a written-to, superseded, or expired block is
never resident ANYWHERE.

Every hook is a no-op without targets, so storage wiring stays
unconditional.
"""

from __future__ import annotations


class CacheInvalidator:
    """Targeted invalidation surface over the node's resident tiers:
    the decoded-block cache and/or the compressed resident pool (each
    may be None)."""

    def __init__(self, cache=None, pool=None) -> None:
        self.cache = cache
        self.pool = pool

    def _targets(self):
        # len() without the target lock is a cheap hint: an empty tier
        # (the common case on the hot write path) skips its lock
        out = []
        if self.cache is not None and len(self.cache) > 0:
            out.append(self.cache)
        if self.pool is not None and len(self.pool) > 0:
            out.append(self.pool)
        return out

    def on_write(self, namespace: str, shard_id: int, series_id: bytes, block_start: int) -> int:
        """Shard.write / write_batch: a datapoint landed in (series, block).
        The buffered point overlays cached fileset arrays at read time, so
        entries are not stale — but drop them anyway: the contract is that
        a written-to block is re-merged from source on next read (and the
        resident scan must fall back to the streamed path, which sees the
        buffer overlay)."""
        dropped = 0
        for t in self._targets():
            dropped += t.invalidate_series_block(
                namespace, shard_id, series_id, block_start
            )
        return dropped

    def on_flush(self, namespace: str, shard_id: int, fileset_ids) -> int:
        """warm_flush/cold_flush: each flushed FilesetID supersedes every
        lower volume of its block (cold flush merges into a new volume);
        superseded entries can never hit again — reclaim their bytes."""
        targets = self._targets()
        dropped = 0
        for fid in fileset_ids:
            for t in targets:
                dropped += t.invalidate_block(
                    namespace, shard_id, fid.block_start, below_volume=fid.volume
                )
        return dropped

    def on_tick_expire(self, namespace: str, shard_id: int, block_starts) -> int:
        """Tick retention expiry: the fileset is deleted off disk."""
        targets = self._targets()
        dropped = 0
        for bs in block_starts:
            for t in targets:
                dropped += t.invalidate_block(namespace, shard_id, bs)
        return dropped
