"""Binary operations with vector matching.

Port of ``m3_tpu/query/functions/binary.py``: arithmetic, comparison with
the optional BOOL modifier, and the set operators and/or/unless, driven by
the ``intersect`` series matcher. Matching runs on the host (tag hashing,
data-independent); the per-step math is elementwise torch on the gathered
rows, on the values' device.

dtypes follow the reference's: rows gathered for a vector–vector operator
are float32 (the reference's ``jnp.take``), and so are ``^`` (``jnp.power``)
and ``%`` (Go's ``math.Mod`` through ``jnp.trunc``) whatever their operands;
``+ - * /`` on ungathered operands keep torch's promotion, which is
numpy's (float64 when either side is).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...block.core import SeriesMeta, Tags

__all__ = [
    "VectorMatching",
    "intersect",
    "arithmetic",
    "comparison",
    "logical_and",
    "logical_or",
    "logical_unless",
    "ARITH_FNS",
    "COMP_FNS",
]

NAME_TAG = b"__name__"
F32 = torch.float32


@dataclass
class VectorMatching:
    """on/ignoring matching (binary/types.go VectorMatching)."""

    on: bool = False  # True: match only on `matching_labels`
    matching_labels: tuple[bytes, ...] = ()


def _match_key(tags: Tags, matching: VectorMatching) -> Tags:
    labels = matching.matching_labels
    if matching.on:
        return tuple((k, v) for k, v in tags if k in labels)
    return tuple((k, v) for k, v in tags if k not in labels and k != NAME_TAG)


def intersect(
    matching: VectorMatching,
    l_metas: list[SeriesMeta],
    r_metas: list[SeriesMeta],
) -> tuple[np.ndarray, np.ndarray, list[SeriesMeta]]:
    """(take_left, corresponding_right, out_metas) — binary.go intersect()."""
    r_index: dict[Tags, int] = {}
    for i, rm in enumerate(r_metas):
        r_index.setdefault(_match_key(rm.tags, matching), i)
    take_left, take_right, metas = [], [], []
    for i, lm in enumerate(l_metas):
        key = _match_key(lm.tags, matching)
        j = r_index.get(key)
        if j is not None:
            take_left.append(i)
            take_right.append(j)
            metas.append(SeriesMeta(tags=key, name=lm.name))
    return (
        np.asarray(take_left, np.int32),
        np.asarray(take_right, np.int32),
        metas,
    )


def _go_mod(x, y):
    # Go math.Mod semantics: result sign follows x (arithmetic.go uses
    # math.Mod). The quotient is taken in the operands' promoted dtype and
    # the rest in float32, as the reference's jnp.trunc makes it.
    q = torch.trunc((x / y).to(F32))
    return x.to(F32) - q * y.to(F32)


ARITH_FNS = {
    "+": lambda x, y: x + y,
    "-": lambda x, y: x - y,
    "*": lambda x, y: x * y,
    "/": lambda x, y: x / y,
    "^": lambda x, y: torch.pow(x.to(F32), y.to(F32)),
    "%": _go_mod,
}


COMP_FNS = {
    "==": lambda x, y: x == y,
    "!=": lambda x, y: x != y,
    ">": lambda x, y: x > y,
    "<": lambda x, y: x < y,
    ">=": lambda x, y: x >= y,
    "<=": lambda x, y: x <= y,
}


def _gather(values, idx):
    """Rows ``idx`` of ``values`` as float32 (the reference's jnp.take)."""
    values = torch.as_tensor(values)
    rows = torch.as_tensor(np.asarray(idx, np.int64), device=values.device)
    return values.to(F32).index_select(0, rows)


def arithmetic(op: str, l_values, r_values, take_left, take_right):
    lv = _gather(l_values, take_left)
    rv = _gather(r_values, take_right)
    return ARITH_FNS[op](lv, rv)


def comparison(op: str, l_values, r_values, take_left, take_right, return_bool: bool):
    """comparison.go: filter mode keeps lhs value where true else NaN; BOOL
    mode is toFloat(cmp) with plain IEEE NaN comparisons — NaN > y is 0,
    NaN != y is 1, exactly like the reference's Go float comparisons."""
    lv = _gather(l_values, take_left)
    rv = _gather(r_values, take_right)
    cond = COMP_FNS[op](lv, rv)
    if return_bool:
        return cond.to(lv.dtype)
    return torch.where(cond, lv, torch.nan)


def _key_set(metas: list[SeriesMeta], matching: VectorMatching):
    return {_match_key(m.tags, matching) for m in metas}


def _right_rows(l_metas, r_metas, matching: VectorMatching) -> np.ndarray:
    """Per lhs series, the first rhs series with its match key (-1: none)."""
    r_keys: dict[Tags, int] = {}
    for j, rm in enumerate(r_metas):
        r_keys.setdefault(_match_key(rm.tags, matching), j)
    return np.asarray(
        [r_keys.get(_match_key(lm.tags, matching), -1) for lm in l_metas], np.int64
    )


def logical_and(l_values, r_values, l_metas, r_metas, matching: VectorMatching):
    """and.go: keep lhs series whose match key exists in rhs AND rhs has a
    value at that step."""
    r_idx = _right_rows(l_metas, r_metas, matching)
    take = np.flatnonzero(r_idx >= 0)
    l_values = torch.as_tensor(l_values)
    if not len(take):
        return torch.zeros((0, l_values.shape[1]), dtype=F32, device=l_values.device), []
    lv = _gather(l_values, take)
    rv = _gather(r_values, r_idx[take])
    return torch.where(torch.isnan(rv), torch.nan, lv), [l_metas[i] for i in take]


def logical_or(l_values, r_values, l_metas, r_metas, matching: VectorMatching):
    """or.go: all lhs series (with NaN steps filled from a matching rhs
    series, or.go:88-95), plus rhs series whose key is absent from lhs."""
    lv = torch.as_tensor(l_values).to(F32)
    r_idx = _right_rows(l_metas, r_metas, matching)
    if len(r_metas) and (r_idx >= 0).any():
        rvv = _gather(r_values, np.maximum(r_idx, 0))
        matched = torch.as_tensor(r_idx >= 0, device=lv.device)[:, None]
        lv = torch.where(matched & torch.isnan(lv), rvv, lv)
    l_keys = _key_set(l_metas, matching)
    keep_r = [j for j, rm in enumerate(r_metas) if _match_key(rm.tags, matching) not in l_keys]
    out = torch.cat([lv, _gather(r_values, keep_r)], dim=0) if keep_r else lv
    return out, list(l_metas) + [r_metas[j] for j in keep_r]


def logical_unless(l_values, r_values, l_metas, r_metas, matching: VectorMatching):
    """unless.go: lhs series whose key is NOT in rhs; where key IS in rhs,
    keep lhs values only at steps where rhs is NaN."""
    lv = torch.as_tensor(l_values).to(F32)
    r_idx = _right_rows(l_metas, r_metas, matching)
    if len(r_metas):
        rvv = _gather(r_values, np.maximum(r_idx, 0))
        masked = torch.where(torch.isnan(rvv), lv, torch.nan)
    else:
        masked = lv
    unmatched = torch.as_tensor(r_idx < 0, device=lv.device)[:, None]
    return torch.where(unmatched, lv, masked), list(l_metas)
