"""Metric tag filters: glob patterns + conjunctive tag filter maps.

A copy of ``m3_tpu/rules/filters.py`` (plain Python).

Reference: M3's src/metrics/filters/ — filter.go glob patterns
(wildcard '*', negation '!', char ranges '[a-z]' and alternation '{a,b}'),
tags_filter.go `ParseTagFilterValueMap` ("tag1:pat1 tag2:pat2") + conjunction
matching.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..block.core import Tags


def glob_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "*":
            out.append(".*")
        elif ch == "[":
            j = pattern.find("]", i)
            if j < 0:
                out.append(re.escape(ch))
            else:
                out.append(pattern[i : j + 1])
                i = j
        elif ch == "{":
            j = pattern.find("}", i)
            if j < 0:
                out.append(re.escape(ch))
            else:
                alts = pattern[i + 1 : j].split(",")
                out.append("(?:" + "|".join(re.escape(a) for a in alts) + ")")
                i = j
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


@dataclass
class Filter:
    """Single-value glob filter with optional '!' negation (filter.go:90-130)."""

    pattern: str

    def __post_init__(self) -> None:
        pat = self.pattern
        self.negated = pat.startswith("!")
        if self.negated:
            pat = pat[1:]
        self._re = re.compile("^" + glob_to_regex(pat) + "$")

    def matches(self, value: bytes | str) -> bool:
        if isinstance(value, bytes):
            value = value.decode()
        ok = self._re.match(value) is not None
        return ok != self.negated


@dataclass
class TagsFilter:
    """Conjunction of per-tag filters (tags_filter.go:137+)."""

    filters: dict[bytes, Filter]

    @staticmethod
    def parse(s: str) -> "TagsFilter":
        """ParseTagFilterValueMap: space-separated `name:pattern` pairs."""
        filters: dict[bytes, Filter] = {}
        for part in s.split():
            if ":" not in part:
                raise ValueError(f"invalid tag filter {part!r}")
            name, pat = part.split(":", 1)
            filters[name.encode()] = Filter(pat)
        return TagsFilter(filters)

    def matches(self, tags: Tags) -> bool:
        tag_map = dict(tags)
        for name, f in self.filters.items():
            v = tag_map.get(name)
            if f.negated and v is None:
                # absent tag satisfies a pure-negation filter
                if f.pattern == "!*" or f.matches(b""):
                    continue
                return False
            if v is None:
                return False
            if not f.matches(v):
                return False
        return True
