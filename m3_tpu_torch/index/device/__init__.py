"""Device-resident inverted index tier (port of ``m3_tpu/index/device/``):
term dictionaries and postings of sealed segments held on the card and
queried by two kernels.

- kernels.py — K1 batched term binary search and K2 postings-union
  bitmaps (``csrc/index_kernels.cu``) with their plain PyTorch twins, and
  the shared fixed-width key ordering definition;
- segment.py — DeviceSegment: SealedSegment-surface wrapper evaluating
  whole query ASTs on the card, bit-identical to the host executor;
- store.py — DeviceIndexStore: seal-time admission, one upload per
  segment, LRU eviction under a byte budget;
- batch.py — prematch: one K1 launch for a query's exact leaves over
  every resident segment.
"""

from .kernels import bitmap_to_docids
from .segment import DeviceSegment, classify_regexp
from .store import DeviceIndexStore, IndexDeviceOptions

__all__ = [
    "DeviceIndexStore",
    "DeviceSegment",
    "IndexDeviceOptions",
    "bitmap_to_docids",
    "classify_regexp",
]
