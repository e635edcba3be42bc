"""Device-side ingest: the write-path twin of the resident read pool.

Port of ``m3_tpu/ingest/``. ``ColumnWriteBuffer`` (buffer.py) accumulates
write batches into per-shard ``(series_lane, slot)`` timestamp/value planes
-- ring-buffered per block window, mirrored to the device with the resident
pool's lease discipline -- while seal encodes the block's lanes with kernel
B-4 (``ops/encode.py``) and admits them born resident
(``resident/pool.admit_block_device``), with no host encode and no
admission upload of their pages.
"""

from .buffer import SPILL_REASONS, ColumnWriteBuffer, IngestOptions, SealLane

__all__ = ["SPILL_REASONS", "ColumnWriteBuffer", "IngestOptions", "SealLane"]
