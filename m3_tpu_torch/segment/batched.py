"""Columnar batched-segment container: whole streams for the device.

Port of ``m3_tpu/segment/batched.py``. N series' finalized M3TSZ streams
are packed into dense arrays:

- ``words``: uint32[S, W], each stream's bytes packed big-endian into 32-bit
  words (bit 0 of the stream is the MSB of word 0), zero-padded to the batch
  maximum plus two words. MSB-first packing matches the OStream bit order,
  so the device's bit cursor is a flat bit index.
- ``num_bits``: int32[S], valid bits per series.

This is the input of ``ops.decode.decode_batched`` (kernel B-6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..utils.xtime import Unit


@dataclass
class BatchedSegments:
    words: np.ndarray  # uint32[S, W]
    num_bits: np.ndarray  # int32[S]

    @property
    def num_series(self) -> int:
        return self.words.shape[0]

    @property
    def num_words(self) -> int:
        return self.words.shape[1]

    @staticmethod
    def from_streams(streams: Sequence[bytes], pad_words: int | None = None) -> "BatchedSegments":
        """Pack finalized M3TSZ streams into a dense word matrix."""
        n = len(streams)
        max_len = max((len(s) for s in streams), default=0)
        w = (max_len + 3) // 4
        if pad_words is not None:
            w = max(w, pad_words)
        # two zero words past the longest stream: a 4-word fetch near its
        # end reads zeros before the index clamp repeats the last word
        w += 2
        words = np.zeros((n, w), dtype=np.uint32)
        num_bits = np.zeros((n,), dtype=np.int32)
        for i, s in enumerate(streams):
            num_bits[i] = len(s) * 8
            if not s:
                continue
            padded = s + b"\x00" * (-len(s) % 4)
            words[i, : len(padded) // 4] = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
        return BatchedSegments(words=words, num_bits=num_bits)

    def initial_units(self, default_unit=None) -> np.ndarray:
        """Per-series initial time-unit codes for the device decoder.

        Mirrors initialTimeUnit (m3tsz/timestamp_encoder.go:208-219): the
        default unit applies only when the stream's first 64-bit timestamp is
        an exact multiple of it, else the stream starts unitless (0) and
        carries a time-unit marker."""
        if default_unit is None:
            default_unit = Unit.SECOND
        if self.num_words < 2:
            return np.zeros((self.num_series,), dtype=np.int32)
        nt = (self.words[:, 0].astype(np.uint64) << np.uint64(32)) | self.words[:, 1].astype(
            np.uint64
        )
        aligned = (nt % np.uint64(default_unit.nanos())) == 0
        has_first = self.num_bits >= 64
        return np.where(aligned & has_first, np.int32(default_unit), np.int32(0))

    def stream(self, i: int) -> bytes:
        """Series i's stream bytes (for tests and host round trips)."""
        nbytes = int(self.num_bits[i]) // 8
        raw = self.words[i].astype(">u4").tobytes()
        return raw[:nbytes]
