"""Port parity: the m3_tpu_torch codec and synthetic data against m3_tpu's.

The same numpy-seeded inputs go through both packages; the encoded bytes,
the decoded datapoints and the prescan snapshots must be identical.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from m3_tpu.codec import m3tsz as jm
from m3_tpu.ops import chunked as jchunked
from m3_tpu.utils import synthetic as jsyn
from m3_tpu.utils.xtime import Unit as JUnit
from m3_tpu_torch.codec import m3tsz as tm
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.utils import synthetic as tsyn
from m3_tpu_torch.utils.xtime import Unit as TUnit

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
KINDS = ["gauge", "counter", "float", "tu", "ann"]


def _inputs(kind, seed=11, n=97):
    """Timestamps, values and per-point (unit, annotation) for one stream."""
    rng = np.random.default_rng(seed)
    ts = T0 + NANOS * (10 * np.arange(n) + rng.integers(-2, 3, n))
    if kind == "gauge":
        vals = np.round(50 + np.cumsum(rng.normal(0, 1, n)), 2)
    elif kind == "counter":
        vals = np.cumsum(rng.integers(0, 100, n)).astype(np.float64)
    else:
        vals = rng.lognormal(0, 2, n)
    ann_at = set(rng.integers(0, n, 3).tolist()) if kind == "ann" else set()
    units = ["ms" if kind == "tu" and j >= n // 2 else "s" for j in range(n)]
    return ts.tolist(), vals.tolist(), units, ann_at


def _encode(pkg, unit_cls, kind):
    ts, vals, units, ann_at = _inputs(kind)
    enc = pkg.Encoder(int(ts[0]))
    for j, (t, v, u) in enumerate(zip(ts, vals, units)):
        enc.encode(
            int(t), float(v),
            unit=unit_cls.MILLISECOND if u == "ms" else unit_cls.SECOND,
            annotation=b"deploy" if j in ann_at else None,
        )
    return enc.stream()


@pytest.mark.parametrize("kind", KINDS)
def test_encoder_bytes_match(kind):
    assert _encode(tm, TUnit, kind) == _encode(jm, JUnit, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches(kind):
    data = _encode(jm, JUnit, kind)
    want = jm.decode(data)
    got = tm.decode(data)
    assert len(got) == len(want) == 97
    for g, w in zip(got, want):
        assert g.timestamp == w.timestamp
        assert np.float64(g.value).tobytes() == np.float64(w.value).tobytes()
        assert int(g.unit) == int(w.unit)
        assert g.annotation == w.annotation


@pytest.mark.parametrize("kind", ["gauge", "counter", "float"])
def test_synthetic_streams_match(kind):
    assert tsyn.synthetic_streams(12, 97, seed=3, kind=kind) == jsyn.synthetic_streams(
        12, 97, seed=3, kind=kind
    )


def test_synthetic_mixed_streams_match():
    kw = dict(seed=31, frac_tu_change=0.1, frac_annotation=0.1)
    assert tsyn.synthetic_mixed_streams(40, 97, **kw) == jsyn.synthetic_mixed_streams(40, 97, **kw)


@pytest.mark.parametrize("k", [16, 24])
def test_snapshot_stream_matches(k):
    """Side-table snapshots, including the fast/fast_float classification,
    for every class of the mixed workload."""
    streams = jsyn.synthetic_mixed_streams(40, 97, seed=31, frac_tu_change=0.1,
                                           frac_annotation=0.1)
    streams += [_encode(jm, JUnit, kind) for kind in KINDS]
    for data in streams:
        assert tchunked.snapshot_stream(data, k) == jchunked.snapshot_stream(data, k)


def test_port_imports_neither_jax_nor_m3_tpu():
    """No module of the port, and not chip_smoke.py, imports jax* or the
    JAX package; every subpackage of the port is covered."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    root = repo / "m3_tpu_torch"
    files = sorted(root.rglob("*.py")) + [repo / "chip_smoke.py"]
    covered = {p.relative_to(root).parts[0] for p in files if p.is_relative_to(root)}
    assert {"aggregator", "block", "codec", "ingest", "metrics", "ops", "parallel", "query",
            "rules", "segment", "utils"} <= covered
    for name in ("mesh.py", "stream.py", "scan.py"):
        assert root / "parallel" / name in files
    assert root / "segment" / "batched.py" in files
    assert root / "ops" / "encode.py" in files and root / "ingest" / "buffer.py" in files
    assert root / "query" / "functions" / "temporal_fused.py" in files
    for name in ("binary.py", "linear.py", "temporal_window.py"):
        assert root / "query" / "functions" / name in files
    assert root / "query" / "cost.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "m3_tpu"), f"{path}: imports {name}"


def test_entry_points_refuse_cpu_fallback():
    """Without a card, the entry points raise unless the caller asks for
    the CPU; with device='cpu' they run."""
    from m3_tpu_torch import resolve_device
    from m3_tpu_torch.ops import fused

    batch = tchunked.build_chunked(tsyn.synthetic_streams(2, 30, seed=1), k=16)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.pack_lanes(batch)
    packed = fused.pack_lanes(batch, device="cpu")
    assert packed.windows.device.type == "cpu"
