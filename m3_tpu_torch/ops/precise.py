"""Compensated (float-float) summation for the f32 aggregates.

Port of ``m3_tpu/ops/precise.py``: the same error-free transformations and
power-of-two tree, on torch tensors.
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth 2Sum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker's version; requires |a| >= |b| (used for renormalization)."""
    s = a + b
    e = b - (s - a)
    return s, e


def dd_add(a, b):
    """(hi, lo) + (hi, lo) → normalized (hi, lo)."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def compensated_sum(x: torch.Tensor, dim: int = -1):
    """Float-float tree sum along ``dim``; returns (hi, lo) with that dim
    reduced. hi + lo is within ~1 ulp of the exact sum of the f32 inputs."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    hi = torch.nn.functional.pad(x, (0, p - n))
    lo = torch.zeros_like(hi)
    while hi.shape[-1] > 1:
        half = hi.shape[-1] // 2
        hi, lo = dd_add((hi[..., :half], lo[..., :half]), (hi[..., half:], lo[..., half:]))
    return hi[..., 0], lo[..., 0]
