"""Bootstrap process: an ordered source chain with shard-time-range
accounting.

A copy of ``m3_tpu/storage/bootstrap.py``.

Reference: M3's src/dbnode/storage/bootstrap/process.go:147 —
the process computes the shard-time-ranges a node must cover (its owned
shards × the retention window's block starts), then walks the bootstrapper
chain (filesystem → commitlog+snapshot → peers → uninitialized_topology,
bootstrapper/base.go); each source claims the sub-ranges it can fulfill
and passes the remainder down. Peers (bootstrapper/peers/source.go:117)
streams shards with no local provenance from replicas; uninitialized
claims ranges no replica can serve (a brand-new cluster's shards).

Sources here are callables bound to Database internals:

    source(ns_name, remaining: ShardTimeRanges) -> ShardTimeRanges  # fulfilled

The Database composes its fs/snapshot/commitlog restoration into such
callables (database.py bootstrap()); a peers source, for shards gained
through placement changes, waits for the cluster slice (ROADMAP §A10)."""

from __future__ import annotations

from dataclasses import dataclass, field


class ShardTimeRanges:
    """shard id → set of block-start nanos still to cover."""

    def __init__(self, ranges: dict[int, set[int]] | None = None) -> None:
        self.ranges: dict[int, set[int]] = {
            s: set(bs) for s, bs in (ranges or {}).items() if bs
        }

    @staticmethod
    def for_window(
        shard_ids, start_nanos: int, end_nanos: int, block_size_nanos: int
    ) -> "ShardTimeRanges":
        first = (start_nanos // block_size_nanos) * block_size_nanos
        blocks = set(range(first, end_nanos, block_size_nanos))
        return ShardTimeRanges({s: set(blocks) for s in shard_ids})

    def is_empty(self) -> bool:
        return not self.ranges

    def num_blocks(self) -> int:
        return sum(len(bs) for bs in self.ranges.values())

    def shards(self) -> list[int]:
        return sorted(self.ranges)

    def copy(self) -> "ShardTimeRanges":
        return ShardTimeRanges(self.ranges)

    def add(self, shard: int, block_start: int) -> None:
        self.ranges.setdefault(shard, set()).add(block_start)

    def add_shard_blocks(self, shard: int, block_starts) -> None:
        if block_starts:
            self.ranges.setdefault(shard, set()).update(block_starts)

    def subtract(self, other: "ShardTimeRanges") -> None:
        for s, bs in other.ranges.items():
            mine = self.ranges.get(s)
            if mine is None:
                continue
            mine -= bs
            if not mine:
                del self.ranges[s]

    def intersect(self, other: "ShardTimeRanges") -> "ShardTimeRanges":
        out: dict[int, set[int]] = {}
        for s, bs in self.ranges.items():
            ob = other.ranges.get(s)
            if ob:
                common = bs & ob
                if common:
                    out[s] = common
        return ShardTimeRanges(out)

    def to_dict(self) -> dict[int, list[int]]:
        return {s: sorted(bs) for s, bs in sorted(self.ranges.items())}

    def __repr__(self) -> str:  # debugging / bootstrap result logging
        return f"ShardTimeRanges({self.to_dict()})"


@dataclass
class BootstrapResult:
    """Per-source fulfillment accounting (bootstrap/result/ role)."""

    target_blocks: int = 0
    fulfilled_by_source: dict[str, int] = field(default_factory=dict)
    unfulfilled: dict[int, list[int]] = field(default_factory=dict)

    def record(self, source_name: str, fulfilled: ShardTimeRanges) -> None:
        self.fulfilled_by_source[source_name] = (
            self.fulfilled_by_source.get(source_name, 0) + fulfilled.num_blocks()
        )


class BootstrapProcess:
    """Walk the source chain, each claiming from the remaining ranges."""

    def __init__(self, sources: list[tuple[str, object]]) -> None:
        self.sources = sources  # [(name, callable)]

    def run(self, ns_name: str, target: ShardTimeRanges) -> BootstrapResult:
        result = BootstrapResult(target_blocks=target.num_blocks())
        remaining = target.copy()
        for name, source in self.sources:
            if remaining.is_empty():
                break
            fulfilled = source(ns_name, remaining)
            # a source may only claim what was still remaining
            fulfilled = fulfilled.intersect(remaining)
            result.record(name, fulfilled)
            remaining.subtract(fulfilled)
        result.unfulfilled = remaining.to_dict()
        return result


def uninitialized_source(has_peer_with_shard=None):
    """Last-chain source (bootstrapper/uninitialized): claim ranges no
    replica can serve — a brand-new cluster's shards legitimately start
    empty. ``has_peer_with_shard(shard) -> bool`` narrows the claim when
    topology knowledge exists; with none, everything left is claimed."""

    def source(ns_name: str, remaining: ShardTimeRanges) -> ShardTimeRanges:
        out = ShardTimeRanges()
        for shard, blocks in remaining.ranges.items():
            if has_peer_with_shard is not None and has_peer_with_shard(shard):
                continue  # a peer owns data for this shard: do NOT claim empty
            out.add_shard_blocks(shard, blocks)
        return out

    return source
