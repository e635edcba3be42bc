"""Device-memory accounting: the live-buffer half of the device tier.

Port of ``m3_tpu/profiling/device.py``. Answers "what is holding device
memory right now" with the split the storage layers think in:

- ``resident_pool``: the resident pool's page buffer and side planes
  (resident/: the compressed working set);
- ``decoded_cache``: the decoded-block cache's bytes (cache/);
- ``index``: the device-resident inverted index tier (index/device/);
- ``other``: every other live allocation on the card (staging tensors,
  kernel outputs still referenced, query intermediates).

Published as ``m3tpu_device_memory_bytes{kind}`` gauges, refreshed on the
stack sampler's schedule and on demand. The live total is
``torch.cuda.memory_allocated()`` on the pool's device, read only when
CUDA is already initialized: the sampler's daemon thread must never be
the one that initializes it. Otherwise it falls back to the resident and
index bytes, as the reference does for a process that has not imported
jax.
"""

from __future__ import annotations

from ..utils.instrument import DEFAULT as METRICS

KINDS = ("resident_pool", "decoded_cache", "index", "other")

_HELP = (
    "live device/process memory by holder: resident_pool = the paged "
    "compressed HBM pool, decoded_cache = decoded-block cache arrays, "
    "index = device-resident inverted index segments, "
    "other = remaining live jax buffers"
)


def _gauge(kind: str):
    return METRICS.gauge("device_memory_bytes", _HELP, labels={"kind": kind})


def _live_bytes(pool) -> int | None:
    """Bytes the caching allocator holds in live tensors on the pool's card
    (the current card without a pool), or None when CUDA is not
    initialized in this process."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    dev = getattr(pool, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        dev = torch.cuda.current_device()
    return int(torch.cuda.memory_allocated(dev))


def collect_device_memory(db=None) -> dict:
    """Snapshot the split, set the gauges, return the dict (the
    ``device_memory.json`` shape; the live total keeps the reference's key,
    ``total_live_jax_bytes``). ``db`` is any Database-surface object; None
    still accounts ``other``. Never raises: a process mid-teardown reports
    what it can."""
    resident = 0
    cache = 0
    index_bytes = 0
    pool = getattr(db, "resident_pool", None) if db is not None else None
    if pool is not None:
        resident = pool.device_bytes()
    index_store = getattr(db, "index_device_store", None) if db is not None else None
    if index_store is not None:
        index_bytes = index_store.device_bytes()
    block_cache = getattr(db, "block_cache", None) if db is not None else None
    if block_cache is not None:
        try:
            cache = int(block_cache.stats().get("bytes", 0))
        except Exception:
            cache = 0
    try:
        total_live = _live_bytes(pool)
    except Exception:
        total_live = None
    if total_live is None:
        total_live = resident + index_bytes
    # the decoded cache holds host arrays: it is accounted from its own
    # byte budget, not subtracted from the device total
    other = max(total_live - resident - index_bytes, 0)
    out = {
        "resident_pool": resident,
        "decoded_cache": cache,
        "index": index_bytes,
        "other": other,
        "total_live_jax_bytes": total_live,
    }
    for kind in KINDS:
        _gauge(kind).set(float(out[kind]))
    return out
