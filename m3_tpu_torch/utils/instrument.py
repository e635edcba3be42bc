"""Process metrics registry: counters and gauges with label sets.

A copy of the ``Counter``/``Gauge``/``Registry``/``DEFAULT`` subset of
``m3_tpu/utils/instrument.py`` (the resident pool's accounting needs it:
``resident_upload_bytes_total`` is the zero-transfer contract of warm
resident scans). Histograms, the text expositions and the kernel profilers
wait for the observability slice (ROADMAP §A9).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class Counter:
    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self._v = v

    def add(self, n: float) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


@dataclass
class _Family:
    kind: str  # counter | gauge
    help: str
    children: dict = field(default_factory=dict)  # labels tuple -> metric


class Registry:
    """Named metric families with label children."""

    def __init__(self, prefix: str = "") -> None:
        self.prefix = prefix
        self._fams: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _child(self, name: str, kind: str, help_: str, labels: dict | None, ctor):
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._fams.get(name)
            if fam is None:
                fam = self._fams[name] = _Family(kind, help_)
            elif fam.kind != kind:
                raise ValueError(f"metric {name} already registered as {fam.kind}")
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = ctor()
            return child

    def counter(self, name: str, help: str = "", labels: dict | None = None) -> Counter:
        return self._child(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", labels: dict | None = None) -> Gauge:
        return self._child(name, "gauge", help, labels, Gauge)

    def collect(self) -> dict:
        """{name: {"kind", "help", "children": [{"labels", "value"}]}}."""
        with self._lock:
            fams = {n: (f.kind, f.help, dict(f.children)) for n, f in sorted(self._fams.items())}
        return {
            f"{self.prefix}{name}": {
                "kind": kind,
                "help": help_,
                "children": [
                    {"labels": dict(labels), "value": m.value}
                    for labels, m in sorted(children.items())
                ],
            }
            for name, (kind, help_, children) in fams.items()
        }


# the process-default registry
DEFAULT = Registry(prefix="m3tpu_")
