"""Device-resident compressed series store and the scans that decode from it
(port of ``m3_tpu/resident/``)."""

from .heat import ShardHeat
from .pool import (
    AdmitResult,
    ResidentChunkedPlan,
    ResidentEntry,
    ResidentOptions,
    ResidentPool,
    ResidentPoolError,
)
from .scan import resident_fetch_arrays, resident_scan_totals, streamed_scan_totals

__all__ = [
    "AdmitResult",
    "ResidentChunkedPlan",
    "ResidentEntry",
    "ResidentOptions",
    "ResidentPool",
    "ResidentPoolError",
    "ShardHeat",
    "resident_fetch_arrays",
    "resident_scan_totals",
    "streamed_scan_totals",
]
