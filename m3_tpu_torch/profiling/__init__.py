"""Continuous profiling, always on.

Port of ``m3_tpu/profiling/``:

- **host tier**: :class:`StackSampler` (sampler.py), a wall-clock stack
  sampler folding ``sys._current_frames()`` snapshots into a bounded,
  time-windowed folded-stack table;
- **device tier**: ``utils.instrument.KernelProfiler`` at every kernel
  seam (dispatch counts, sampled dispatch seconds bounded by a CUDA event,
  the launch's cost), plus the live device-memory split
  (``m3tpu_device_memory_bytes{kind}``, device.py);
- **fleet tier**: ``merge_profiles`` / ``collect_fleet_profile``
  (merge.py).

A process installs its sampler here (``install``) so the surfaces that
serve profiles find it, as ``instrument.DEFAULT`` is the process registry.
Profiler health is self-metered as ``m3tpu_profile_*``.
"""

from __future__ import annotations

from .device import collect_device_memory
from .merge import collect_fleet_profile, merge_profiles
from .sampler import StackSampler, default_hz, folded_text

__all__ = [
    "StackSampler",
    "collect_device_memory",
    "collect_fleet_profile",
    "default_hz",
    "folded_text",
    "install",
    "installed",
    "merge_profiles",
    "process_profile",
    "start_sampler",
]

# the process's installed sampler (the instrument.DEFAULT pattern): op
# handlers and debug routes read it; services install at startup
_SAMPLER: StackSampler | None = None


def install(sampler: StackSampler | None) -> None:
    global _SAMPLER
    _SAMPLER = sampler


def installed() -> StackSampler | None:
    return _SAMPLER


def process_profile(seconds: float | None = None) -> dict:
    """The installed sampler's profile — the one shape the ``profile``
    wire op and every pprof route serve. A process without a sampler
    (profiling disabled) answers with an explicit empty profile instead
    of erroring: the fleet merge must see 'nothing here', not a hole."""
    sampler = _SAMPLER
    if sampler is None:
        return {
            "enabled": False,
            "instance": "",
            "hz": 0.0,
            "seconds": 0.0,
            "samples": 0,
            "folded": {},
        }
    return sampler.profile(seconds=seconds)


def start_sampler(
    hz: float | None = None, instance: str = "", db=None, **kwargs
) -> StackSampler | None:
    """Service-startup helper: build, start, and install the process
    sampler with device-memory accounting attached (``db`` may be None:
    the accountant still reads the live device bytes). Returns None when the
    resolved rate is 0 (profiling off)."""
    hz = default_hz() if hz is None else max(float(hz), 0.0)
    if hz <= 0:
        return None
    sampler = StackSampler(
        hz=hz,
        instance=instance,
        memory=lambda: collect_device_memory(db),
        **kwargs,
    )
    sampler.start()
    install(sampler)
    return sampler
