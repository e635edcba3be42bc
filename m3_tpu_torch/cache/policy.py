"""Admission policy + configuration for the decoded-block cache.

A copy of ``m3_tpu/cache/policy.py``.

Reference: M3 gates what its caches may hold — the postings-list cache
admits only immutable segments (postings_list_cache.go), the wired list
caps resident blocks (block/wired_list.go). Here admission is explicit
policy: only SEALED fileset blocks are cacheable (the caller enforces
that by construction — buffers never reach the cache), plus a minimum
decoded size (tiny blocks cost more in bookkeeping than re-decode) and
an optional namespace allowlist.

``CacheOptions`` is a plain dataclass, loadable through the YAML config
system like every other service config block::

    cache:
      enabled: true
      max_bytes: 268435456
      min_block_bytes: 0
      namespaces: [default]
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CacheOptions:
    """Decoded-block cache knobs (x/config-style dataclass schema).

    ``max_bytes`` is the byte budget for decoded arrays (HBM-style cost
    accounting: an entry costs the sum of its arrays' nbytes plus a fixed
    per-entry overhead). ``min_block_bytes`` rejects blocks whose decoded
    size is below the threshold. ``namespaces`` empty means all
    namespaces are cacheable."""

    enabled: bool = True
    max_bytes: int = 256 * 1024 * 1024
    min_block_bytes: int = 0
    namespaces: list = field(default_factory=list)

    def validate(self) -> None:
        from ..utils.config import ConfigError

        if self.max_bytes < 0:
            raise ConfigError("cache.max_bytes must be >= 0")
        if self.min_block_bytes < 0:
            raise ConfigError("cache.min_block_bytes must be >= 0")


class AdmissionPolicy:
    """Decides whether a decoded block may enter the cache."""

    def __init__(self, options: CacheOptions) -> None:
        self.options = options
        self._namespaces = frozenset(options.namespaces or ())

    def admit(self, key, nbytes: int) -> bool:
        """``key`` is a BlockKey; ``nbytes`` the entry's decoded cost."""
        o = self.options
        if not o.enabled or o.max_bytes <= 0:
            return False
        if nbytes > o.max_bytes:
            return False  # an entry larger than the whole budget
        if nbytes < o.min_block_bytes:
            return False
        if self._namespaces and key.namespace not in self._namespaces:
            return False
        return True
