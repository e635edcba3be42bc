"""Port parity for instrumentation and continuous profiling:
``m3_tpu_torch/utils/instrument.py`` (histograms, expositions,
``JitTracker``, ``KernelProfiler``), ``m3_tpu_torch/profiling/`` and the
kernel seams, beside ``m3_tpu``'s.

- The registry: the same sequence of calls gives the same ``collect()``,
  ``expose()`` and ``expose_openmetrics()`` text (exemplars included).
- ``KernelProfiler``: deterministic sampling, first sightings in the jit
  counters, cost capture (the port's cost callable takes the place of the
  HLO analysis) and its error counting, the tenant attribution hook.
- Mirrors of every case of ``tests/test_profiling.py`` that needs no wire,
  coordinator or selfmon collector (those wait for ROADMAP §A10): the
  stack sampler (folded tables equal for the same fake frames and clock),
  the fleet merge, the device-memory split and the shard-heat cases.
- The kernel seams' dispatch counts per query, on the CPU, against the
  reference's for the plan, staged, scan and temporal paths.
- ``tools.m3lint`` finds nothing in the port.
"""

import time

import numpy as np
import pytest

from m3_tpu import profiling as jprofiling
from m3_tpu.index.device.store import IndexDeviceOptions as JIndexDeviceOptions
from m3_tpu.profiling import device as jdevice
from m3_tpu.profiling import merge as jmerge
from m3_tpu.profiling import sampler as jsampler
from m3_tpu.query import engine as jengine
from m3_tpu.query import m3_storage as jm3s
from m3_tpu.query import plan as jplan
from m3_tpu.query import tenants as jtenants
from m3_tpu.resident import ResidentOptions as JResidentOptions
from m3_tpu.resident.heat import ShardHeat as JShardHeat
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import NamespaceOptions as JNamespaceOptions
from m3_tpu.utils import instrument as jinstrument
from m3_tpu_torch import profiling as tprofiling
from m3_tpu_torch.index.device import IndexDeviceOptions
from m3_tpu_torch.profiling import device as tdevice
from m3_tpu_torch.profiling import merge as tmerge
from m3_tpu_torch.profiling import sampler as tsampler
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query import m3_storage as tm3s
from m3_tpu_torch.query import plan as tplan
from m3_tpu_torch.query import tenants as ttenants
from m3_tpu_torch.query.promql import Matcher
from m3_tpu_torch.resident import ResidentOptions
from m3_tpu_torch.resident.heat import ShardHeat as TShardHeat
from m3_tpu_torch.storage.database import Database as TDatabase
from m3_tpu_torch.storage.database import NamespaceOptions as TNamespaceOptions
from m3_tpu_torch.utils import instrument as tinstrument
from m3_tpu_torch.utils import schedule as tschedule

NANOS = 1_000_000_000
HOUR = 3600 * NANOS
T0 = 1_600_000_000 * NANOS
STEP = 10 * NANOS

INSTRUMENTS = (jinstrument, tinstrument)
SAMPLERS = (jsampler, tsampler)


# --- fake frames: fold_frames only touches f_code/f_back ---


class _Code:
    def __init__(self, filename, name):
        self.co_filename = filename
        self.co_name = name


class _Frame:
    def __init__(self, name, filename="proj/pkg/mod.py", back=None):
        self.f_code = _Code(filename, name)
        self.f_back = back


def _chain(*names):
    """A leaf frame whose f_back chain is names root->leaf."""
    frame = None
    for name in names:
        frame = _Frame(name, back=frame)
    return frame


def _counter_value(reg, name, labels=None):
    fam = reg.collect().get(name)
    if not fam:
        return 0.0
    want = labels or {}
    return sum(c["value"] for c in fam["children"]
               if all(c["labels"].get(k) == v for k, v in want.items()))


# ---------------------------------------------------------------------------
# the registry and its expositions
# ---------------------------------------------------------------------------


def _registry_calls(instrument):
    reg = instrument.Registry(prefix="m3tpu_")
    reg.counter("reqs_total", "requests", {"op": "read"}).inc(3)
    reg.counter("reqs_total", "requests", {"op": 'we"ird\\\n'}).inc()
    reg.gauge("depth", "queue depth").set(7.5)
    reg.gauge("depth", "queue depth", {"kind": "x"}).add(-2)
    h = reg.histogram("lat_seconds", "latency", {"op": "read"}, buckets=(0.1, 1.0))
    for v, tid, tenant in ((0.05, "aa", "alpha"), (0.5, None, None), (0.7, "bb", None),
                           (3.0, "cc", "beta"), (1.0, None, None)):
        h.observe(v, trace_id=tid, tenant=tenant)
    reg.histogram("empty_seconds")
    with pytest.raises(ValueError):
        reg.gauge("reqs_total")
    return reg


def test_registry_expositions_equal_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    want, got = (_registry_calls(m) for m in INSTRUMENTS)
    assert got.collect() == want.collect()
    assert got.expose() == want.expose()
    assert got.expose_openmetrics() == want.expose_openmetrics()
    text = got.expose_openmetrics()
    assert text.endswith("# EOF\n") and "# TYPE m3tpu_reqs counter" in text
    assert 'le="1.0"} 4 # {trace_id="bb"} 0.7 1700000000.123456717' in text
    assert 'op="we\\"ird\\\\\\n"' in got.expose()


def test_histogram_exemplar_tenant():
    for instrument in INSTRUMENTS:
        h = instrument.Registry(prefix="m3tpu_").histogram("lat_seconds", buckets=(1.0,))
        h.observe(0.5, trace_id="abc", tenant="alpha")
        h.observe(2.0, trace_id="def")
        by_le = {r["le"]: r for r in h.exemplar_rows()}
        assert by_le[1.0]["tenant"] == "alpha"
        assert "tenant" not in by_le[float("inf")]


# ---------------------------------------------------------------------------
# JitTracker and KernelProfiler
# ---------------------------------------------------------------------------


def _profiler_run(instrument, rate):
    """A fixed sequence of dispatches: the counters and the histograms'
    counts (not their wall-time sums)."""
    reg = instrument.Registry(prefix="m3tpu_")
    prof = instrument.KernelProfiler("probe", registry=reg, sample_rate=rate, capture_costs=False)
    jit = instrument.JitTracker("probe_jit", registry=reg)
    sampled = []
    for i in range(23):
        with prof.dispatch(("k", i % 4) if i % 5 else None) as d:
            sampled.append(d.sampled)
            d.done(None)
        with jit.track(i % 3):
            pass
    with pytest.raises(RuntimeError), prof.dispatch(("k", 99)):
        raise RuntimeError("a failed launch is not a dispatch")
    out = {}
    for name, fam in reg.collect().items():
        if name == "m3tpu_jit_compile_seconds_total":  # wall time
            continue
        for c in fam["children"]:
            out[(name, tuple(sorted(c["labels"].items())))] = (
                c["value"] if "value" in c else (c["count"], len(c["buckets"])))
    return sampled, out


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_kernel_profiler_sampling_and_counters_equal_the_reference(rate):
    want, got = (_profiler_run(m, rate) for m in INSTRUMENTS)
    assert got == want
    sampled, counters = got
    assert sum(sampled) == {0.0: 0, 0.3: 6, 1.0: 23}[rate]
    assert counters[("m3tpu_kernel_dispatches_total", (("kernel", "probe"),))] == 23
    assert counters[("m3tpu_jit_compiles_total", (("kernel", "probe"),))] == 4
    assert counters[("m3tpu_jit_compiles_total", (("kernel", "probe_jit"),))] == 3


def test_kernel_profiler_attributes_device_seconds(monkeypatch):
    """test_tenant.py's case: a sampled dispatch under a tenant context
    charges its seconds to that tenant; outside one, nobody."""
    for instrument, tenants in ((jinstrument, jtenants), (tinstrument, ttenants)):
        led = tenants.TenantLedger(max_tenants=8, registry=instrument.Registry(prefix="m3tpu_"))
        monkeypatch.setattr(tenants, "LEDGER", led)
        prof = instrument.KernelProfiler("test_decode", registry=instrument.Registry(
            prefix="m3tpu_"), sample_rate=1.0)
        with tenants.tenant_context("alpha"):
            with prof.dispatch():  # key=None: sampled, not a first sighting
                pass
        with prof.dispatch():
            pass
        row = led.window_totals("alpha")
        assert row is not None and row["decode_seconds"] > 0
        assert led.window_totals(tenants.DEFAULT_TENANT) is None


def test_dispatch_counter_charges_the_active_record():
    from m3_tpu_torch.query import stats

    prof = tinstrument.KernelProfiler("probe_count", registry=tinstrument.Registry())
    with prof.dispatch():
        pass  # between queries: nothing to charge
    st = stats.start("probe")
    try:
        for _ in range(3):
            with prof.dispatch(("k",)):
                pass
    finally:
        stats.finish(st, 0.0)
    assert st.device_dispatches == 3 and st.to_dict()["deviceDispatches"] == 3


def test_kernel_cost_capture_once_per_signature():
    """The reference captures the compiled HLO's cost; the port calls the
    wrapper's cost function with the launch's arguments, once a key."""
    reg = tinstrument.Registry(prefix="m3tpu_")
    prof = tinstrument.KernelProfiler("cost_probe", registry=reg, sample_rate=1.0)
    assert prof.capture_costs  # sampling on => cost capture on
    calls = []

    def cost(x, scale=1.0):
        calls.append(x)
        return {"flops": 2.0 * x * scale, "bytes_accessed": 8.0 * x}

    for _ in range(2):
        with prof.dispatch(("k", 32), cost=(cost, (32,), {"scale": 0.5})) as d:
            d.done(None)
    assert calls == [32]
    assert prof.cost_analysis() == {"('k', 32)": {"flops": 32.0, "bytes_accessed": 256.0}}
    assert _counter_value(reg, "m3tpu_kernel_cost_captures_total", {"kernel": "cost_probe"}) == 1
    assert _counter_value(reg, "m3tpu_kernel_flops", {"kernel": "cost_probe"}) == 32.0
    assert _counter_value(reg, "m3tpu_kernel_bytes_accessed", {"kernel": "cost_probe"}) == 256.0


@pytest.mark.parametrize("instrument", INSTRUMENTS, ids=["m3_tpu", "port"])
def test_kernel_cost_capture_off_by_default(instrument):
    reg = instrument.Registry(prefix="m3tpu_")
    prof = instrument.KernelProfiler("cost_off", registry=reg, sample_rate=0.0)
    assert not prof.capture_costs
    assert prof.capture_cost("k", None) is None  # no-op, no error counted
    assert _counter_value(reg, "m3tpu_kernel_cost_errors_total", {"kernel": "cost_off"}) == 0


@pytest.mark.parametrize("instrument", INSTRUMENTS, ids=["m3_tpu", "port"])
def test_kernel_cost_env_zero_forces_capture_off(instrument, monkeypatch):
    monkeypatch.setenv("M3_TPU_PROFILE_COST", "0")
    reg = instrument.Registry(prefix="m3tpu_")
    assert not instrument.KernelProfiler("cost_forced_off", registry=reg,
                                         sample_rate=1.0).capture_costs
    monkeypatch.setenv("M3_TPU_PROFILE_COST", "1")
    assert instrument.KernelProfiler("cost_forced_on", registry=reg,
                                     sample_rate=0.0).capture_costs
    monkeypatch.setenv("M3_TPU_PROFILE_SAMPLE_RATE", "0.25")
    monkeypatch.delenv("M3_TPU_PROFILE_COST")
    prof = instrument.KernelProfiler("env_rate", registry=reg)
    assert prof.sample_rate == 0.25 and prof.capture_costs


@pytest.mark.parametrize("instrument", INSTRUMENTS, ids=["m3_tpu", "port"])
def test_kernel_cost_capture_tolerates_broken_lowerable(instrument):
    reg = instrument.Registry(prefix="m3tpu_")
    prof = instrument.KernelProfiler("cost_broken", registry=reg, capture_costs=True)

    class NotLowerable:
        pass

    assert prof.capture_cost("k", NotLowerable()) is None
    assert prof.capture_cost("k", NotLowerable()) is None  # once a key
    assert _counter_value(reg, "m3tpu_kernel_cost_errors_total", {"kernel": "cost_broken"}) == 1


def test_kernel_costs_of_r_and_b2():
    """The wrappers' cost functions: kernel R's bytes are its lanes' valid
    window words (at least the words their bits occupy), its planes and its
    records; B2's one read and one write a function of the f32 matrix."""
    import torch

    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    streams = synthetic_streams(6, 90, seed=5)
    batch = chunked.build_chunked(streams, k=32)
    packed = fused.pack_lanes(batch, order="s", device="cpu")
    n, cw = packed.n, packed.windows.shape[0]
    occupied = valid = 0
    for data in streams:
        for p in chunked.snapshot_stream(data, 32):
            if p["span"] > 0:
                occupied += min(cw, -(-((p["off"] & 31) + p["span"]) // 32))
    for j in range(n):
        rel, end = int(packed.lanes[0, j]), int(packed.lanes[1, j])
        valid += min(cw, -(-end // 32)) if end > rel else 0
    cost = chunked.decode_records_cost(packed.windows, packed.lanes, n, 32)
    assert cost == {"flops": 0.0, "bytes_accessed": float(
        valid * 4 + n * 17 * 4 + n * 32 * 19 + n)}
    assert valid >= occupied
    v = torch.zeros((5, 40))
    assert TF.launch_cost(v, 7, 10.0, ("rate", "delta")) == {
        "flops": float(5 * (2 * sum(min(7, t + 1) for t in range(40)) + 40) * 2),
        "bytes_accessed": float(5 * 40 * 4 * 3)}


def test_chunked_scan_aggregate_matches_the_reference():
    """The records-decode scan (kernel R's seam, ``chunked_decode``) vs
    ``m3_tpu``'s chunked_scan_aggregate on the same streams: counts exact,
    f32 values to the f32 sums' reordering."""
    import jax.numpy as jnp

    from m3_tpu.ops.chunked import build_chunked as jbuild_chunked
    from m3_tpu.parallel import scan as jscan
    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.parallel import scan as tscan
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    streams = synthetic_streams(12, 150, seed=9)
    jb = jbuild_chunked(streams, k=32)
    lane_args = {f: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
                 for f, v in jscan.chunked_device_args(jb, device_put=False).items()}
    want = jscan.chunked_scan_aggregate(lane_args, len(streams), jb.num_chunks, 32)
    batch = chunked.build_chunked(streams, k=32)
    packed = fused.pack_lanes(batch, order="s", device="cpu")
    before = _counter_value(tinstrument.DEFAULT, "m3tpu_kernel_dispatches_total",
                            {"kernel": "chunked_decode"})
    got = tscan.chunked_scan_aggregate(packed, len(streams), batch.num_chunks, 32)
    assert _counter_value(tinstrument.DEFAULT, "m3tpu_kernel_dispatches_total",
                          {"kernel": "chunked_decode"}) == before + 1
    np.testing.assert_array_equal(got.series_count.numpy(), np.asarray(want.series_count))
    assert int(got.total_count) == int(want.total_count)
    for f in ("series_sum", "series_min", "series_max", "series_last"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)
    for f in ("total_sum", "total_min", "total_max"):
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)), rtol=1e-6)
    assert not got.series_err.any()


# ---------------------------------------------------------------------------
# tests/test_profiling.py: the stack sampler
# ---------------------------------------------------------------------------


def test_fold_frames_root_first_and_truncation():
    for sampler in SAMPLERS:
        stack, truncated = sampler.fold_frames(_chain("root", "mid", "leaf"), max_depth=8)
        assert stack == "proj/pkg/mod.py:root;proj/pkg/mod.py:mid;proj/pkg/mod.py:leaf"
        assert truncated == 0
        stack, truncated = sampler.fold_frames(_chain("a", "b", "c", "d", "e"), max_depth=2)
        assert truncated == 3
        parts = stack.split(";")
        assert parts[0] == sampler.TRUNCATED_FRAME
        assert [p.split(":")[1] for p in parts[1:]] == ["d", "e"]
    assert tsampler.frame_label(_Frame("f", "/a/b/c/d/e.py")) == "c/d/e.py:f"


def _deterministic_run(sampler, instrument):
    reg = instrument.Registry(prefix="m3tpu_")
    now = [0.0]
    s = sampler.StackSampler(hz=0, bucket_seconds=10.0, window_seconds=60.0,
                             clock=lambda: now[0], registry=reg)
    for tick in range(25):
        now[0] = tick * 0.25
        s.sample_once(frames={1: _chain("serve", "fetch", "decode"),
                              2: _chain("serve", "flush" if tick % 3 else "seal")})
    prof = s.profile(seconds=60)
    counters = {k: v for k, v in reg.collect().items() if "overhead" not in k}
    return prof, counters


def test_sampler_determinism_with_injected_clock():
    """Same fake frames + same clock -> the same tables twice over and in
    both packages."""
    a, b = _deterministic_run(tsampler, tinstrument), _deterministic_run(tsampler, tinstrument)
    want = _deterministic_run(jsampler, jinstrument)
    assert a == b == want
    assert a[0]["folded"] and a[0]["samples"] == 50  # 25 ticks x 2 threads


def _bounded(sampler, instrument):
    reg = instrument.Registry(prefix="m3tpu_")
    s = sampler.StackSampler(hz=0, max_stacks=2, max_depth=3, clock=lambda: 0.0, registry=reg)
    s.sample_once(now=0.0, frames={1: _chain("a", "x")})
    s.sample_once(now=0.0, frames={1: _chain("b", "x")})
    s.sample_once(now=0.0, frames={1: _chain("c", "x")})  # third distinct stack
    folded = s.profile()["folded"]
    s.sample_once(now=0.0, frames={1: _chain("a", "x", "y", "z", "w")})
    return folded, {name: _counter_value(reg, f"m3tpu_profile_{name}") for name in (
        "stacks_truncated_total", "frames_truncated_total", "samples_total")}


def test_bounded_table_and_truncation_counters():
    want, got = (_bounded(s, i) for s, i in zip(SAMPLERS, INSTRUMENTS))
    assert got == want
    folded, counters = got
    assert folded[tsampler.OVERFLOW_STACK] == 1 and len(folded) == 3
    # the deep stack is a fourth distinct one: it overflows too
    assert counters == {"stacks_truncated_total": 2, "frames_truncated_total": 2,
                        "samples_total": 4}


def test_windowed_retention_drops_old_buckets():
    for sampler, instrument in zip(SAMPLERS, INSTRUMENTS):
        now = [5.0]
        s = sampler.StackSampler(hz=0, bucket_seconds=10.0, window_seconds=30.0,
                                 clock=lambda: now[0], registry=instrument.Registry())
        s.sample_once(frames={1: _chain("old")})
        now[0] = 95.0
        s.sample_once(frames={1: _chain("new")})  # eviction runs here
        assert [k.split(":")[-1] for k in s.profile(seconds=600)["folded"]] == ["new"]
        assert s.profile(seconds=10)["folded"]
        assert s.profile(seconds=600)["seconds"] == 30.0


def test_profile_golden_contains_synthetic_hot_frame():
    """A REAL sample (sys._current_frames) of this thread folds a stack
    through the known hot frame, root-first."""
    s = tsampler.StackSampler(hz=0, clock=lambda: 0.0, registry=tinstrument.Registry())

    def _synthetic_hot_frame_xyz():
        return s.sample_once(now=0.0)

    assert _synthetic_hot_frame_xyz() >= 1
    hot = [st for st in s.profile()["folded"] if "_synthetic_hot_frame_xyz" in st]
    assert hot
    stack = hot[0]
    assert stack.index("test_profile_golden") < stack.index(
        "_synthetic_hot_frame_xyz") < stack.index("sample_once")


def test_folded_text_format():
    for sampler in SAMPLERS:
        assert sampler.folded_text({"a;b": 3, "c": 5}) == "c 5\na;b 3\n"
        assert sampler.folded_text({}) == ""


def test_sampler_errors_counted_never_raised():
    for sampler, instrument in zip(SAMPLERS, INSTRUMENTS):
        reg = instrument.Registry(prefix="m3tpu_")
        s = sampler.StackSampler(hz=0, clock=lambda: 0.0, registry=reg)

        class Boom:
            @property
            def f_code(self):
                raise RuntimeError("torn frame")

            f_back = None

        class BoomFrames(dict):
            def items(self):
                raise RuntimeError("no frames")

        assert s.sample_once(now=0.0, frames=BoomFrames()) == 0
        assert s.sample_once(now=0.0, frames={1: Boom()}) == 0
        assert _counter_value(reg, "m3tpu_profile_errors_total") == 2


def test_process_profile_install_surface():
    """The install half of the reference's case (its dbnode wire op waits
    for ROADMAP §A10)."""
    for profiling, sampler in ((jprofiling, jsampler), (tprofiling, tsampler)):
        prev = profiling.installed()
        try:
            profiling.install(None)
            empty = profiling.process_profile()
            assert empty == {"enabled": False, "instance": "", "hz": 0.0, "seconds": 0.0,
                             "samples": 0, "folded": {}}
            s = sampler.StackSampler(hz=0, instance="me", clock=lambda: 0.0)
            s.sample_once(now=0.0, frames={1: _chain("f")})
            profiling.install(s)
            assert profiling.process_profile()["samples"] == 1
            assert profiling.process_profile(seconds=30)["instance"] == "me"
        finally:
            profiling.install(prev)


def test_start_sampler_runs_the_loop_and_stops(monkeypatch):
    """start_sampler on its ticker: a real thread at 200 Hz for a moment,
    the device-memory accountant on its schedule, stopped cleanly."""
    prev = tprofiling.installed()
    try:
        assert tprofiling.start_sampler(hz=0) is None
        s = tprofiling.start_sampler(hz=200.0, instance="loop", memory_interval=0.01)
        deadline = time.monotonic() + 2.0
        while (s.profile()["samples"] == 0 or s._last_memory is None) and time.monotonic() < deadline:
            time.sleep(0.01)
        s.stop()
        assert tprofiling.installed() is s
        assert s.profile()["samples"] > 0
        assert set(s._last_memory) == {"resident_pool", "decoded_cache", "index", "other",
                                       "total_live_jax_bytes"}
        assert s._thread is None
    finally:
        tprofiling.install(prev)


def test_fixed_rate_ticker_skips_missed_ticks():
    from m3_tpu.utils import schedule as jschedule

    for schedule in (jschedule, tschedule):
        now = [100.0]
        t = schedule.FixedRateTicker(1.0, phase_key="a", clock=lambda: now[0], jitter=False)
        t.stop.set()  # never sleeps: the stop event answers at once
        assert t.next_deadline() == 101.0
        now[0] = 104.5
        assert t.wait_next() == (True, 3)
        assert t.next_deadline() == 105.0
        assert schedule.phase_fraction("node-1") == jschedule.phase_fraction("node-1")
        assert schedule.check_telemetry_interval(0, "x") == 0.0
        with pytest.raises(ValueError):
            schedule.check_telemetry_interval(0.5, "selfmon")
        with pytest.raises(ValueError):
            schedule.FixedRateTicker(0)


# ---------------------------------------------------------------------------
# tests/test_profiling.py: the fleet merge
# ---------------------------------------------------------------------------


def _prof(folded):
    return {"enabled": True, "folded": folded, "samples": sum(folded.values())}


def test_merge_profiles_by_stack_with_instance_tags():
    profiles = [("node0", _prof({"serve;decode": 3, "serve;flush": 1})),
                ("node1", _prof({"serve;decode": 2})), ("node2", None)]
    merged = tmerge.merge_profiles(profiles)
    assert merged == jmerge.merge_profiles(profiles)
    assert merged["folded"] == {"serve;decode": 5, "serve;flush": 1}
    assert merged["byInstance"]["serve;decode"] == {"node0": 3, "node1": 2}


def test_fleet_profile_merges_and_counts_dead_peer():
    class Peer:
        def profile(self, seconds=None):
            return _prof({"serve;decode": 4})

    class DeadPeer:
        def profile(self, seconds=None):
            raise ConnectionError("down")

    peers = {"node0": Peer(), "node1": DeadPeer()}
    before = _counter_value(tinstrument.DEFAULT, "m3tpu_profile_fleet_peer_errors_total")
    out = tmerge.collect_fleet_profile("coord0", _prof({"http;render": 2}), peers, seconds=30)
    assert out == jmerge.collect_fleet_profile("coord0", _prof({"http;render": 2}), peers, 30)
    assert out["instances"] == ["coord0", "node0"]
    assert list(out["errors"]) == ["node1"] and "down" in out["errors"]["node1"]
    assert out["folded"] == {"http;render": 2, "serve;decode": 4} and out["samples"] == 6
    assert _counter_value(tinstrument.DEFAULT,
                          "m3tpu_profile_fleet_peer_errors_total") == before + 1


# ---------------------------------------------------------------------------
# tests/test_profiling.py: the device-memory split and the shard heat
# ---------------------------------------------------------------------------


def _heat_db(kind, path, ns):
    if kind == "port":
        db = TDatabase(str(path), num_shards=2, commitlog_enabled=False, device="cpu",
                       resident_options=ResidentOptions(max_bytes=1 << 22))
        db.create_namespace(ns, TNamespaceOptions())
    else:
        db = JDatabase(str(path), num_shards=2, commitlog_enabled=False,
                       resident_options=JResidentOptions(max_bytes=1 << 22))
        db.create_namespace(ns, JNamespaceOptions())
    return db


def test_device_memory_split(tmp_path):
    got = []
    for kind, device in (("m3_tpu", jdevice), ("port", tdevice)):
        db = _heat_db(kind, tmp_path / kind, "d")
        try:
            before = device.collect_device_memory(db)  # must not force the pool
            sid = db.write_tagged("d", ((b"__name__", b"g"),), T0, 1.0)
            db.write_batch("d", [(sid, T0 + i * 10 * NANOS, float(i)) for i in range(64)])
            db.flush("d", T0 + 4 * 3600 * NANOS)
            after = device.collect_device_memory(db)
            fam = (jinstrument if kind == "m3_tpu" else tinstrument).DEFAULT.collect()[
                "m3tpu_device_memory_bytes"]
            gauges = {c["labels"]["kind"]: c["value"] for c in fam["children"]}
        finally:
            db.close()
        got.append((before, after, gauges, device.collect_device_memory(None)))
    (jb, ja, _, jnone), (tb, ta, tg, tnone) = got
    assert set(ta) == set(ja) and set(tnone) == set(jnone)
    assert tb["resident_pool"] == jb["resident_pool"] == 0
    assert ta["resident_pool"] > 0
    for kind in ("decoded_cache", "index"):
        assert ta[kind] == ja[kind]
    # no CUDA in this process: the live total is the resident and index bytes
    assert ta["total_live_jax_bytes"] == ta["resident_pool"] + ta["index"]
    assert ta["other"] == 0 and tg == {k: float(ta[k]) for k in tdevice.KINDS}
    assert tnone == {"resident_pool": 0, "decoded_cache": 0, "index": 0, "other": 0,
                     "total_live_jax_bytes": 0}


def test_shard_heat_cap_and_counters():
    got = []
    for heat_cls, instrument in ((JShardHeat, jinstrument), (TShardHeat, tinstrument)):
        reg = instrument.Registry(prefix="m3tpu_")
        heat = heat_cls(registry=reg, cap=2)
        heat.charge(0, hits=3)
        heat.charge(1, misses=1, streamed_bytes=100)
        heat.charge(7, hits=1)  # past the cap: collapses into __overflow__
        values = {name: [(c["labels"], c["value"]) for c in fam["children"]]
                  for name, fam in reg.collect().items()}
        got.append((heat.dump(), values))
    assert got[0] == got[1]
    dump, values = got[1]
    assert dump["0"]["hits"] == 3 and dump["1"]["streamedBytes"] == 100 and "7" not in dump
    assert values["m3tpu_resident_shard_overflow_total"] == [({}, 1.0)]


_HEAT_FAMILIES = {"hits": "resident_shard_hits_total",
                  "misses": "resident_shard_misses_total",
                  "streamedBytes": "resident_shard_streamed_bytes_total"}


def _heat_since(kind, before, dump):
    """``dump`` less the registry's counts ``before`` the run: the heat
    counters live in the process registry, so files that ran earlier in
    the same process must not shift the comparison."""
    return {s: {f: v - before.get(s, {}).get(f, 0.0) for f, v in d.items()}
            for s, d in dump.items()}


def _heat_registry(kind):
    reg = (jinstrument if kind == "m3_tpu" else tinstrument).DEFAULT
    fams = reg.collect()
    out = {}
    for field, name in _HEAT_FAMILIES.items():
        for c in fams.get(reg.prefix + name, {"children": []})["children"]:
            out.setdefault(c["labels"]["shard"], {})[field] = c["value"]
    return out


def _heat_routing(kind, path):
    before = _heat_registry(kind)
    db = _heat_db(kind, path, "h")
    m3s = tm3s if kind == "port" else jm3s
    try:
        for i in range(8):
            tags = ((b"__name__", b"heat_gauge"), (b"series", b"%02d" % i))
            sid = db.write_tagged("h", tags, T0, float(i))
            db.write_batch("h", [(sid, T0 + (j + 1) * 10 * NANOS, float(j)) for j in range(32)])
        db.flush("h", T0 + 4 * 3600 * NANOS)
        if kind == "port":
            storage, matcher = m3s.M3Storage(db, "h"), Matcher("__name__", "=", "heat_gauge")
        else:
            from m3_tpu.query.promql import Matcher as JMatcher

            storage, matcher = m3s.M3Storage(db, "h"), JMatcher("__name__", "=", "heat_gauge")
        span = (T0, T0 + 40 * 10 * NANOS)
        heats = [db.resident_stats()["shard_heat"]]
        out = [storage.scan_totals([matcher], *span)]
        heats.append(db.resident_stats()["shard_heat"])
        db.write_tagged("h", ((b"__name__", b"heat_gauge"), (b"series", b"00")),
                        T0 + 33 * 10 * NANOS, 5.0)
        out.append(storage.scan_totals([matcher], *span))
        heats.append(db.resident_stats()["shard_heat"])
        return [(o["path"], o["count"]) for o in out], [_heat_since(kind, before, h) for h in heats]
    finally:
        db.close()


def test_shard_heat_through_query_routing(tmp_path):
    """Resident fetches charge hits per shard, a buffered overlay charges
    misses and streamed bytes, the same in both packages."""
    want, got = (_heat_routing(k, tmp_path / k) for k in ("m3_tpu", "port"))
    assert got == want
    paths, heats = got
    assert [p for p, _ in paths] == ["resident", "streamed"]
    total = lambda h, f: sum(v[f] for v in h.values())
    assert total(heats[1], "hits") - total(heats[0], "hits") >= 8
    assert total(heats[2], "misses") > total(heats[1], "misses")
    assert total(heats[2], "streamedBytes") > total(heats[1], "streamedBytes")


# ---------------------------------------------------------------------------
# the kernel seams: dispatches per query against the reference's
# ---------------------------------------------------------------------------


def _seed(db, n_series=24, n_points=48, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_series):
        tags = ((b"__name__", b"pm"), (b"job", b"app%d" % (i % 3)), (b"s", b"%03d" % i))
        sid = db.write_tagged("ns", tags, T0, float(i))
        vals = ([float(j % 9) for j in range(n_points - 1)] if i % 2 else
                [round(float(rng.standard_normal()), 2) for _ in range(n_points - 1)])
        db.write_batch("ns", [(sid, T0 + (j + 1) * STEP, v) for j, v in enumerate(vals)])
    db.flush("ns", T0 + 4 * HOUR)


@pytest.fixture(scope="module")
def seam_pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("seams")
    j = JDatabase(str(base / "j"), num_shards=2, commitlog_enabled=False,
                  resident_options=JResidentOptions(max_bytes=16 << 20),
                  index_device_options=JIndexDeviceOptions(max_bytes=64 << 20))
    j.create_namespace("ns", JNamespaceOptions(block_size_nanos=HOUR))
    t = TDatabase(str(base / "t"), num_shards=2, commitlog_enabled=False, device="cpu",
                  resident_options=ResidentOptions(max_bytes=16 << 20),
                  index_device_options=IndexDeviceOptions(max_bytes=64 << 20))
    t.create_namespace("ns", TNamespaceOptions(block_size_nanos=HOUR))
    for db in (j, t):
        _seed(db)
    yield j, t
    j.close()
    t.close()


def _dispatches(instrument, fn) -> dict:
    """{kernel: dispatches} that ``fn()`` made, from the process registry."""
    def snap():
        fam = instrument.DEFAULT.collect().get("m3tpu_kernel_dispatches_total", {"children": []})
        return {c["labels"]["kernel"]: c["value"] for c in fam["children"]}

    before = snap()
    fn()
    return {k: v - before.get(k, 0.0) for k, v in snap().items() if v - before.get(k, 0.0)}


SPAN = (T0 + 60 * NANOS, T0 + 460 * NANOS, 20 * NANOS)
Q = 'rate(pm{job=~"app.*"}[2m])'


def _paths(kind, db):
    """Per path, the dispatches one run made (the plan-served query once
    warm, the same query force-staged, a resident and a streamed scan)."""
    if kind == "port":
        instrument, m3s, plan, promql = tinstrument, tm3s, tplan, Matcher
        eng = tengine.Engine(m3s.M3Storage(db, "ns"), device="cpu")
    else:
        from m3_tpu.query.promql import Matcher as promql

        instrument, m3s, plan = jinstrument, jm3s, jplan
        eng = jengine.Engine(m3s.M3Storage(db, "ns"))
    storage = eng.storage
    matchers = [promql("__name__", "=", "pm"), promql("job", "=~", "app.*")]
    run = lambda: eng.query_range(Q, *SPAN)
    out = {"plan cold": _dispatches(instrument, run), "plan warm": _dispatches(instrument, run)}

    def staged():
        with plan.force_staged():
            run()

    out["staged"] = _dispatches(instrument, staged)
    scan = lambda: storage.scan_totals(matchers, T0, T0 + HOUR)
    out["resident scan"] = _dispatches(instrument, scan)
    db.resident_clear()
    out["streamed scan"] = _dispatches(instrument, scan)
    scan()  # the read-through re-admission leaves the pool as it was
    return out


def test_seam_dispatches_per_query_equal_the_reference(seam_pair):
    """Per query, the port's seams dispatch as the reference's on the CPU:
    one ``query_plan`` a plan-served query, cold or warm; the staged path's
    ``resident_chunked_assemble`` (assembly, then the records decode) and the
    scans' one ``resident_chunked_assemble`` (resident) or
    ``packed_lane_agg`` (streamed); no ``temporal_fused`` on the CPU, where
    neither package launches B2. ``index_device`` differs by design: since
    PR 9 the port resolves a segment with one K1 and one K2 (a span-list)
    launch where the reference has K1 and a bm_terms/bm_range launch a
    leaf."""
    j, t = seam_pair
    want, got = _paths("m3_tpu", j), _paths("port", t)
    drop = lambda d: {k: v for k, v in d.items() if k != "index_device"}
    assert {p: drop(d) for p, d in got.items()} == {p: drop(d) for p, d in want.items()}
    assert got["plan warm"] == {"query_plan": 1.0}
    assert got["staged"]["resident_chunked_assemble"] == 2.0
    assert drop(got["resident scan"]) == {"resident_chunked_assemble": 1.0}
    assert drop(got["streamed scan"]) == {"packed_lane_agg": 1.0}
    # the port's index_device: a K1 and a K2 dispatch per segment searched
    for path in ("staged", "resident scan", "streamed scan"):
        assert got[path]["index_device"] == 2.0, path
    assert "index_device" not in got["plan warm"]


# ---------------------------------------------------------------------------
# the repo's linter over the port
# ---------------------------------------------------------------------------


def test_m3lint_finds_nothing_in_the_port():
    from tools.m3lint import lint_paths

    res = lint_paths(["m3_tpu_torch"])
    assert res.errors == [] and res.findings == [], res.findings[:5]
    assert res.files_scanned >= 90
