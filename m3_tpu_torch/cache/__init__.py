"""Decoded-block cache (a copy of ``m3_tpu/cache/``).

The repeated-query analog of KV-cache residency management in an
inference stack: sealed immutable fileset blocks decode once, the
(times, values, valid) arrays stay device-placeable and hot, and a byte
budget (HBM-style cost accounting) evicts least-recently-used entries.
Mirrors M3's caching on the same path — the postings-list LRU
(src/dbnode/storage/index/postings_list_cache.go) and per-shard seeker
cache (persist/fs/seek_manager.go) — but for decoded datapoints, where
the scan-and-aggregate hot path spends its time.
"""

from .block_cache import BlockCache, BlockKey, DecodedBlock
from .invalidation import CacheInvalidator
from .policy import AdmissionPolicy, CacheOptions

__all__ = [
    "AdmissionPolicy",
    "BlockCache",
    "BlockKey",
    "CacheInvalidator",
    "CacheOptions",
    "DecodedBlock",
]
