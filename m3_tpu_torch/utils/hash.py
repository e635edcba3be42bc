"""murmur3-32 — the shard hash function.

A copy of ``m3_tpu/utils/hash.py``: the port places series on the same
shards as the reference, so both packages read each other's filesets.

Reference: sharding/shardset.go:149 `DefaultHashFn` = murmur3.Sum32(id) %
numShards (github.com/m3db/stackmurmur3). Both a scalar and a numpy-batch
implementation so host shard routing matches the reference placement exactly.
"""

from __future__ import annotations

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    h = seed & M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k = (k * _C1) & M32
        k = _rotl32(k, 15)
        k = (k * _C2) & M32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & M32
    k = 0
    tail = data[nblocks * 4 :]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & M32
        k = _rotl32(k, 15)
        k = (k * _C2) & M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def shard_for(id_bytes: bytes, num_shards: int) -> int:
    """sharding/shardset.go:149 DefaultHashFn."""
    return murmur3_32(id_bytes) % num_shards


def murmur3_32_batch(ids: list[bytes], seed: int = 0) -> np.ndarray:
    return np.asarray([murmur3_32(b, seed) for b in ids], np.uint32)
