"""Mapping and rollup rules + the active rule set matcher.

A copy of ``m3_tpu/rules/rules.py`` (plain Python over the port's
``block/core.py`` tags and ``utils/serialize.py`` ids).

Reference: M3's src/metrics/rules/ — mapping.go (filter → storage
policies / drop), rollup.go + rollup_target.go (filter → rollup metric with
grouped tags + pipeline), active_ruleset.go ForwardMatch, matcher/ per-ID
match caching, and src/metrics/transformation/ unary ops.

Rules are versioned via snapshots with cutover times exactly like
ruleset.go's snapshots: a match at time T uses the latest snapshot whose
cutover <= T.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..block.core import Tags, make_tags
from ..metrics.policy import StoragePolicy
from ..metrics.types import AggregationType
from .filters import TagsFilter

NAME_TAG = b"__name__"
ROLLUP_TAG = b"m3_rollup"  # marks generated rollup metrics


class TransformationType(enum.IntEnum):
    """src/metrics/transformation/type.go."""

    UNKNOWN = 0
    ABSOLUTE = 1
    PERSECOND = 2
    INCREASE = 3
    ADD = 4
    RESET = 5


@dataclass(frozen=True)
class RollupTarget:
    """rollup_target.go: new metric from grouped tags + policies."""

    new_name: bytes
    group_by: tuple[bytes, ...]  # tags retained on the rollup metric
    aggregations: tuple[AggregationType, ...] = ()
    policies: tuple[StoragePolicy, ...] = ()
    pipeline: tuple[TransformationType, ...] = ()


@dataclass
class MappingRule:
    """mapping.go: filter → storage policies (or drop)."""

    name: str
    filter: TagsFilter
    policies: tuple[StoragePolicy, ...] = ()
    aggregations: tuple[AggregationType, ...] = ()
    drop: bool = False
    cutover_nanos: int = 0


@dataclass
class RollupRule:
    name: str
    filter: TagsFilter
    targets: tuple[RollupTarget, ...] = ()
    cutover_nanos: int = 0


@dataclass
class MatchResult:
    """active_ruleset.go ForwardMatch output."""

    policies: tuple[StoragePolicy, ...] = ()
    aggregations: tuple[AggregationType, ...] = ()
    drop: bool = False
    rollups: tuple[tuple[Tags, RollupTarget], ...] = ()


@dataclass
class RuleSet:
    """Versioned rule set (ruleset.go): snapshots selected by cutover time."""

    mapping_rules: list[MappingRule] = field(default_factory=list)
    rollup_rules: list[RollupRule] = field(default_factory=list)
    version: int = 1

    def active_at(self, time_nanos: int) -> "ActiveRuleSet":
        return ActiveRuleSet(
            [r for r in self.mapping_rules if r.cutover_nanos <= time_nanos],
            [r for r in self.rollup_rules if r.cutover_nanos <= time_nanos],
        )


class ActiveRuleSet:
    """ForwardMatch (active_ruleset.go:119+) with per-ID result caching
    (matcher/cache)."""

    def __init__(self, mapping_rules, rollup_rules) -> None:
        self.mapping_rules = mapping_rules
        self.rollup_rules = rollup_rules
        self._cache: dict[Tags, MatchResult] = {}

    def forward_match(self, tags: Tags) -> MatchResult:
        cached = self._cache.get(tags)
        if cached is not None:
            return cached
        policies: list[StoragePolicy] = []
        aggs: list[AggregationType] = []
        drop = False
        for rule in self.mapping_rules:
            if rule.filter.matches(tags):
                if rule.drop:
                    drop = True
                policies.extend(rule.policies)
                aggs.extend(rule.aggregations)
        rollups = []
        for rule in self.rollup_rules:
            if rule.filter.matches(tags):
                for target in rule.targets:
                    kept = tuple(
                        (k, v) for k, v in tags if k in target.group_by
                    )
                    out_tags = make_tags(
                        [(NAME_TAG, target.new_name), (ROLLUP_TAG, b"true"), *kept]
                    )
                    rollups.append((out_tags, target))
        result = MatchResult(
            policies=tuple(dict.fromkeys(policies)),
            aggregations=tuple(dict.fromkeys(aggs)),
            drop=drop,
            rollups=tuple(rollups),
        )
        self._cache[tags] = result
        return result


def encode_tags_id(tags: Tags) -> bytes:
    """Canonical tag-encoded metric ID (the role of metric/id/m3 ids).

    Length-prefixed wire format (x/serialize/encoder.go:55-191 semantics) so
    tag bytes containing ','/'=' can never produce colliding IDs.
    """
    from ..utils.serialize import encode_tags

    return encode_tags(tags)


def decode_tags_id(mid: bytes) -> Tags:
    from ..utils.serialize import decode_tags

    if not mid:
        return ()
    return tuple(sorted(decode_tags(mid)))
