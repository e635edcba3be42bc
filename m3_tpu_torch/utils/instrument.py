"""Instrumentation: process metrics registry with Prometheus exposition.

Port of ``m3_tpu/utils/instrument.py``: a Registry of Counter/Gauge/
Histogram handles with label sets, rendered in the Prometheus text format
(``expose``) and in OpenMetrics (``expose_openmetrics``, with the
histograms' exemplars inline); ``collect`` is the structured snapshot. The
exposition text and ``collect()`` equal the reference's for the same
sequence of calls.

The device tier is ``KernelProfiler``: dispatch counts, first-sighting
attribution and sampled dispatch seconds at each kernel seam, plus the two
settable seams the query layer installs (``set_kernel_attribution``: a
sampled dispatch's seconds go to the tenant ledger; ``set_dispatch_counter``:
every dispatch counts against the query record on its thread). A sampled
dispatch on the card waits on a CUDA event recorded after its launches,
never on a device-wide synchronize.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field


def _escape_label_value(v) -> str:
    """Prometheus text exposition label-value escaping: backslash, double
    quote, and line feed must be escaped (exposition_formats.md) — regex
    matchers used as label values otherwise corrupt the whole scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_exemplar(ex: tuple) -> str:
    """OpenMetrics exemplar suffix for a bucket sample:
    `` # {trace_id="...",tenant="..."} value timestamp``. ``ex`` is
    Histogram.exemplars' tuple form (value, trace_id, unix_nanos, tenant)."""
    v, trace_id, unix_nanos, tenant = ex
    labels = [("trace_id", trace_id)]
    if tenant is not None:
        labels.append(("tenant", tenant))
    return f" # {_fmt_labels(tuple(labels))} {v} {unix_nanos / 1e9:.9f}"


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
        """Relative adjust (in-flight style gauges): must not lose updates
        under concurrent threads."""
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10
)


class Histogram:
    def __init__(self, buckets=DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        # bucket index -> (value, trace_id, unix_nanos, tenant): the LAST
        # traced observation per bucket (the OpenMetrics exemplar), kept out
        # of the 0.0.4 text exposition, which has no exemplar grammar
        self.exemplars: dict[int, tuple[float, str, int, str | None]] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: str | None = None,
                tenant: str | None = None) -> None:
        with self._lock:
            i = bisect.bisect_left(self.buckets, v)
            self.counts[i] += 1
            self.sum += v
            self.total += 1
            if trace_id is not None:
                self.exemplars[i] = (v, trace_id, time.time_ns(), tenant)

    def snapshot(self) -> tuple[list[int], float, int]:
        """(counts, sum, total) read atomically vs concurrent observe():
        exposition must not report a count/sum pair from different instants."""
        with self._lock:
            return list(self.counts), self.sum, self.total

    def exemplar_rows(self) -> list[dict]:
        """Exemplars as rows keyed by the bucket's ``le`` bound."""
        with self._lock:
            items = sorted(self.exemplars.items())
        out = []
        for i, (v, tid, ts, tenant) in items:
            le = self.buckets[i] if i < len(self.buckets) else float("inf")
            row = {"le": le, "value": v, "traceId": tid, "timeUnixNanos": ts}
            if tenant is not None:
                row["tenant"] = tenant
            out.append(row)
        return out


@dataclass
class _Family:
    kind: str  # counter | gauge | histogram
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

    def histogram(
        self, name: str, help: str = "", labels: dict | None = None, buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._child(name, "histogram", help, labels, lambda: Histogram(buckets))

    def _families(self) -> dict:
        with self._lock:
            return {
                n: (f.kind, f.help, dict(f.children))
                for n, f in sorted(self._fams.items())
            }

    def collect(self) -> dict:
        """Structured snapshot of every family, the machine-readable sibling
        of :meth:`expose`: {name: {"kind", "help", "children": [{"labels",
        ...}]}} where counter/gauge children carry {"value"} and histogram
        children {"sum", "count", "buckets": [[le, cumulative_count], ...]}
        (and "exemplars" when any)."""
        out: dict = {}
        for name, (kind, help_, children) in self._families().items():
            rows = []
            for labels, m in sorted(children.items()):
                row: dict = {"labels": dict(labels)}
                if kind in ("counter", "gauge"):
                    row["value"] = m.value
                else:
                    counts, h_sum, h_total = m.snapshot()
                    acc, buckets = 0, []
                    for b, c in zip(m.buckets, counts):
                        acc += c
                        buckets.append([float(b), acc])
                    buckets.append([float("inf"), h_total])
                    row.update(sum=h_sum, count=h_total, buckets=buckets)
                    exemplars = m.exemplar_rows()
                    if exemplars:
                        row["exemplars"] = exemplars
                rows.append(row)
            out[f"{self.prefix}{name}"] = {"kind": kind, "help": help_, "children": rows}
        return out

    def _histogram_lines(self, fam: str, labels: tuple, m: Histogram,
                         exemplars: dict | None) -> list[str]:
        """A histogram child's bucket, sum and count samples; with
        ``exemplars`` (OpenMetrics) each bucket carries its exemplar."""
        counts, h_sum, h_total = m.snapshot()
        lines = []
        acc = 0
        for i, (b, c) in enumerate(zip(m.buckets, counts)):
            acc += c
            lb = tuple(list(labels) + [("le", repr(float(b)))])
            line = f"{fam}_bucket{_fmt_labels(lb)} {acc}"
            ex = exemplars.get(i) if exemplars is not None else None
            lines.append(line + _fmt_exemplar(ex) if ex is not None else line)
        lb = tuple(list(labels) + [("le", "+Inf")])
        line = f"{fam}_bucket{_fmt_labels(lb)} {h_total}"
        ex = exemplars.get(len(m.buckets)) if exemplars is not None else None
        lines.append(line + _fmt_exemplar(ex) if ex is not None else line)
        ls = _fmt_labels(labels)
        lines.append(f"{fam}_sum{ls} {h_sum}")
        lines.append(f"{fam}_count{ls} {h_total}")
        return lines

    def expose_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition. Where it differs from
        :meth:`expose`: a counter family is named without its ``_total``
        suffix in the HELP/TYPE lines while its sample keeps it; histogram
        bucket samples carry their exemplars inline; the text ends with the
        mandatory ``# EOF``."""
        lines = []
        for name, (kind, help_, children) in self._families().items():
            fam = f"{self.prefix}{name}"
            if kind == "counter" and fam.endswith("_total"):
                fam = fam[: -len("_total")]
            if help_:
                lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {kind}")
            for labels, m in sorted(children.items()):
                ls = _fmt_labels(labels)
                if kind == "counter":
                    lines.append(f"{fam}_total{ls} {m.value}")
                elif kind == "gauge":
                    lines.append(f"{fam}{ls} {m.value}")
                else:
                    with m._lock:
                        exemplars = dict(m.exemplars)
                    lines += self._histogram_lines(fam, labels, m, exemplars)
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def expose(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for name, (kind, help_, children) in self._families().items():
            full = f"{self.prefix}{name}"
            if help_:
                lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {kind}")
            for labels, m in sorted(children.items()):
                if kind in ("counter", "gauge"):
                    lines.append(f"{full}{_fmt_labels(labels)} {m.value}")
                else:
                    lines += self._histogram_lines(full, labels, m, None)
        return "\n".join(lines) + "\n"


# the process-default registry
DEFAULT = Registry(prefix="m3tpu_")


class JitTracker:
    """First-sighting attribution: the first call with an unseen key counts
    in m3tpu_jit_compiles_total / m3tpu_jit_compile_seconds_total
    {kernel=...} with its wall time. The reference counts XLA compiles
    there; PyTorch compiles nothing per shape, so here a key's first
    sighting covers what a first call pays instead (on the card, the
    kernel library's first-use load through ``ops/_build``). The rule is
    kept so that the counters and the dispatch histograms' counts equal the
    reference's for the same sequence of calls.

    Usage::

        _JIT = JitTracker("temporal_fused")
        with _JIT.track((funcs, values.shape, window)):
            out = ...
    """

    def __init__(self, kernel: str, registry: Registry | None = None) -> None:
        reg = registry or DEFAULT
        self.kernel = kernel
        self._compiles = reg.counter(
            "jit_compiles_total", "jit cache misses", {"kernel": kernel}
        )
        self._seconds = reg.counter(
            "jit_compile_seconds_total",
            "wall seconds spent in first-call jit compilation",
            {"kernel": kernel},
        )
        self._seen: set = set()
        self._lock = threading.Lock()

    def track(self, key):
        return _JitCall(self, key)

    def _observe(self, key, elapsed: float) -> bool:
        """Record a first sighting; returns whether THIS call was the first
        sighting of ``key``."""
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
        self._compiles.inc()
        self._seconds.inc(elapsed)
        return True


class _JitCall:
    def __init__(self, tracker: JitTracker, key) -> None:
        self.tracker = tracker
        self.key = key

    def __enter__(self) -> "_JitCall":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.tracker._observe(self.key, time.perf_counter() - self._t0)


# device-seconds attribution hook: query/tenants.py installs a callable
# ``(kernel, seconds)`` invoked for every SAMPLED, non-first-sighting
# profiled dispatch, charging its seconds to the tenant context active on
# the dispatching thread. A settable seam (not an import) because this
# module sits below the query layer.
_KERNEL_ATTRIBUTION = None


def set_kernel_attribution(fn) -> None:
    global _KERNEL_ATTRIBUTION
    _KERNEL_ATTRIBUTION = fn


# per-query device-dispatch counter hook: query/stats.py installs a
# callable ``(kernel)`` invoked for EVERY profiled kernel dispatch
# (sampled or not), charging it to the query record active on the
# dispatching thread — the seam a warm plan-served fetch's one dispatch
# is counted through.
_DISPATCH_COUNTER = None


def set_dispatch_counter(fn) -> None:
    global _DISPATCH_COUNTER
    _DISPATCH_COUNTER = fn


# kernel dispatch latencies span ~10µs (a warm tiny batch) to whole seconds
# (a cold full-block scan): finer low end than the RPC buckets
KERNEL_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _env_sample_rate() -> float:
    """M3_TPU_PROFILE_SAMPLE_RATE in [0, 1]; default 0 (profiling off: a
    sampled dispatch waits for its device work, so the default costs
    nothing and the knob is explicit)."""
    try:
        rate = float(os.environ.get("M3_TPU_PROFILE_SAMPLE_RATE", "0"))
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def _env_cost_flag() -> bool | None:
    """M3_TPU_PROFILE_COST: force cost capture on ("1") or off ("0")
    regardless of the sampling rate; unset (None) defers to 'capture iff
    the profiler samples'."""
    raw = os.environ.get("M3_TPU_PROFILE_COST", "")
    if raw == "1":
        return True
    if raw == "0":
        return False
    return None


def _first_cuda_tensor(x):
    """The first CUDA tensor in a result (a tensor, or a tuple, list,
    NamedTuple or dict of them), or None."""
    import torch

    if isinstance(x, torch.Tensor):
        return x if x.is_cuda else None
    if isinstance(x, dict):
        x = x.values()
    if isinstance(x, (tuple, list, type({}.values()))):
        for item in x:
            t = _first_cuda_tensor(item)
            if t is not None:
                return t
    return None


# sampled dispatches whose CUDA-event span is kept per profiler (the
# ``device_samples`` deque): enough for a run's per-kernel medians
DEVICE_SAMPLES = 4096


class KernelProfiler(JitTracker):
    """Device-tier dispatch observability: JitTracker's first-sighting
    attribution plus SAMPLED wall-time profiles of kernel dispatches.

    A launch returns before the card has run it, so wall time around the
    call measures host dispatch only: a sampled dispatch records a CUDA
    event on the result's current stream after the launch and waits on that
    event (never a device-wide synchronize), and the span from
    ``__enter__`` until the device work is done lands in
    ``m3tpu_kernel_dispatch_seconds{kernel=...}`` and goes to the
    attribution hook. A result that lives on the CPU has nothing to wait
    on. The wait covers whatever was queued on the stream before it, other
    threads' launches included. Sampling is DETERMINISTIC (dispatch ``n``
    is sampled iff ``floor(n·rate)`` advances over ``floor((n−1)·rate)``).
    A key's first sighting is excluded from the histogram and counted in
    the jit counters instead, as in the reference.

    A sampled dispatch on the card also keeps its CUDA-event span (an event
    recorded at ``__enter__`` to the one waited on) beside its wall seconds
    in ``device_samples``: (seconds, device ms) pairs, outside the registry.

    Usage::

        _PROF = KernelProfiler("chunked_decode")
        with _PROF.dispatch((shape, k)) as d:
            d.done(decode_chunked_lanes(...))
    """

    def __init__(self, kernel: str, registry: Registry | None = None,
                 sample_rate: float | None = None,
                 capture_costs: bool | None = None) -> None:
        super().__init__(kernel, registry=registry)
        reg = registry or DEFAULT
        self.sample_rate = (
            _env_sample_rate() if sample_rate is None
            else min(max(float(sample_rate), 0.0), 1.0)
        )
        # cost capture: on when the profiler samples, forced on/off by
        # M3_TPU_PROFILE_COST=1/0, decided ONCE at construction
        if capture_costs is None:
            env_flag = _env_cost_flag()
            capture_costs = env_flag if env_flag is not None else self.sample_rate > 0.0
        self.capture_costs = bool(capture_costs)
        labels = {"kernel": kernel}
        self._dispatches = reg.counter(
            "kernel_dispatches_total", "kernel dispatches", labels
        )
        self._hist = reg.histogram(
            "kernel_dispatch_seconds",
            "block_until_ready-bounded wall time of SAMPLED kernel "
            "dispatches (M3_TPU_PROFILE_SAMPLE_RATE; compiles excluded)",
            labels,
            buckets=KERNEL_BUCKETS,
        )
        self._g_flops = reg.gauge(
            "kernel_flops",
            "XLA cost-analysis FLOPs of this kernel's most recent "
            "compilation (Compiled.cost_analysis; with dispatch-seconds "
            "and bytes this turns device time into work done)",
            labels,
        )
        self._g_bytes_accessed = reg.gauge(
            "kernel_bytes_accessed",
            "XLA cost-analysis bytes accessed of this kernel's most "
            "recent compilation",
            labels,
        )
        self._m_cost_captures = reg.counter(
            "kernel_cost_captures_total",
            "HLO cost analyses captured (once per compilation signature)",
            labels,
        )
        self._m_cost_errors = reg.counter(
            "kernel_cost_errors_total",
            "cost-analysis captures that failed (backend without cost "
            "analysis, AOT path unavailable) — capture is best-effort "
            "and never breaks a dispatch",
            labels,
        )
        self._n = 0  # dispatch sequence (guarded by JitTracker._lock)
        self._costs: dict = {}  # key -> {"flops", "bytes_accessed"}
        self._cost_seen: set = set()
        self.device_samples: deque = deque(maxlen=DEVICE_SAMPLES)

    def _next_sampled(self) -> bool:
        rate = self.sample_rate
        with self._lock:
            self._n += 1
            n = self._n
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        return math.floor(n * rate) > math.floor((n - 1) * rate)

    def dispatch(self, key=None, cost=None) -> "_Dispatch":
        """``cost``: optional ``(fn, args, kwargs)``: when this dispatch is
        the first sighting of ``key`` and cost capture is on, its cost is
        recorded through :meth:`capture_cost`."""
        return _Dispatch(self, key, cost)

    def capture_cost(self, key, fn, *args, **kwargs):
        """Record a launch's cost ONCE per ``key``: ``fn(*args, **kwargs)``
        returns the ``{"flops", "bytes_accessed"}`` its wrapper reckons from
        the launch's shapes (there is no compiled HLO to analyse). Failures
        are counted in kernel_cost_errors_total, never raised. Returns the
        dict or None."""
        if not self.capture_costs:
            return None
        with self._lock:
            if key in self._cost_seen:
                return self._costs.get(key)
            self._cost_seen.add(key)
        try:
            analysis = fn(*args, **kwargs)
            if analysis is None:
                analysis = {}
            cost = {
                "flops": float(analysis.get("flops", 0.0)),
                "bytes_accessed": float(analysis.get("bytes_accessed", 0.0)),
            }
        except Exception:
            self._m_cost_errors.inc()
            return None
        with self._lock:
            self._costs[key] = cost
        self._g_flops.set(cost["flops"])
        self._g_bytes_accessed.set(cost["bytes_accessed"])
        self._m_cost_captures.inc()
        return cost

    def cost_analysis(self) -> dict:
        """Captured costs, keyed by the dispatch key's string form."""
        with self._lock:
            return {str(k): dict(v) for k, v in self._costs.items()}


class _Dispatch:
    """One profiled kernel dispatch; call ``done(result)`` with the device
    output so a sampled dispatch can wait on it."""

    __slots__ = ("profiler", "key", "cost", "sampled", "result", "_t0", "_start", "_start_dev")

    def __init__(self, profiler: KernelProfiler, key, cost=None) -> None:
        self.profiler = profiler
        self.key = key
        self.cost = cost  # (fn, args, kwargs) for cost capture
        self.sampled = profiler._next_sampled()
        self.result = None

    def done(self, result):
        self.result = result
        return result

    def __enter__(self) -> "_Dispatch":
        # the clock starts before the start event is recorded: recording
        # can give up the interpreter lock to other threads, and the
        # observed seconds must cover the event span
        self._t0 = time.perf_counter()
        self._start = None
        if self.sampled:
            import torch

            if torch.cuda.is_initialized():
                self._start_dev = torch.cuda.current_device()
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        prof = self.profiler
        prof._dispatches.inc()
        counter = _DISPATCH_COUNTER
        if counter is not None:
            counter(prof.kernel)
        compiled = False
        if self.key is not None:
            compiled = prof._observe(self.key, time.perf_counter() - self._t0)
        if compiled and self.cost is not None:
            fn, args, kwargs = self.cost
            prof.capture_cost(self.key, fn, *args, **(kwargs or {}))
        if self.sampled and not compiled:
            device_ms = None
            out = _first_cuda_tensor(self.result) if self.result is not None else None
            if out is not None:
                import torch

                end = torch.cuda.Event(enable_timing=self._start is not None)
                end.record(torch.cuda.current_stream(out.device))
                end.synchronize()
                if self._start is not None and self._start_dev == out.device.index:
                    device_ms = self._start.elapsed_time(end)
            elapsed = time.perf_counter() - self._t0
            prof._hist.observe(elapsed)
            if device_ms is not None:
                prof.device_samples.append((elapsed, device_ms))
            hook = _KERNEL_ATTRIBUTION
            if hook is not None:
                hook(prof.kernel, elapsed)
