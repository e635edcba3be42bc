"""Runtime options: the live-tunable subset of a running node's knobs.

A copy of the ``RuntimeOptions`` dataclass of ``m3_tpu/storage/runtime.py``
(``Database.apply_runtime_options`` takes it). The KV-watching options
manager waits for the cluster slice (ROADMAP §A10).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RuntimeOptions:
    """The live-tunable subset (M3's runtime/types.go Options)."""

    tick_interval_secs: float = 10.0
    flush_interval_secs: float = 60.0
    snapshot_interval_secs: float = 60.0
    buffer_past_secs: float = 600.0
    # max NEW series insertions per second, 0 = unlimited
    # (kvconfig ClusterNewSeriesInsertLimit)
    write_new_series_limit_per_sec: int = 0
