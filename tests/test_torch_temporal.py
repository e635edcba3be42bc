"""Port parity for the temporal functions and kernel B2.

- Every FUSABLE twin (m3_tpu_torch.query.functions.temporal) equals the jnp
  formula of m3_tpu/query/functions/temporal.py within 1e-5 abs + 1e-5 rel,
  with an identical NaN pattern. This is how the JAX package's own tests
  run B2 on the CPU: ``fused_temporal`` falls back to these formulas
  off-TPU.
- B2's source, compiled as host C++, equals the twin within the
  reference's stated bound (1e-4 abs + 1e-4 rel; 5e-3 abs for stddev/stdvar,
  TOLERANCE.md), with an identical NaN pattern.

Inputs: 96 series x 120 points made with numpy from a seed. "gauge" rows
are stationary (N(50, 5)) with 8% NaN, an all-NaN row, a sparse row and a
row that starts late; "counter" rows are monotone with resets. The
stddev/stdvar formula (E[x^2] - mean^2 about the row's mean) is
ill-conditioned on trending rows, where any change of summation order
moves it beyond the bound (TOLERANCE.md: "degraded when stddev << |mean|"),
so those two are held on the gauge rows only.
"""

import ctypes
import shutil
import subprocess
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.query.functions import temporal_fused as jtf
from m3_tpu_torch.ops import _build
from m3_tpu_torch.query.functions import temporal_fused as TF

WINDOWS = [1, 5, 7, 200]
STEP = 10.0


def _data(kind):
    rng = np.random.default_rng(7 if kind == "gauge" else 8)
    if kind == "gauge":
        v = rng.normal(50, 5, (96, 120)).astype(np.float32)
        v[rng.random(v.shape) < 0.08] = np.nan
        v[3] = np.nan
        v[4, rng.random(120) < 0.9] = np.nan
        v[5, :70] = np.nan
        return v
    v = np.cumsum(rng.integers(0, 20, (96, 120)), axis=1).astype(np.float32)
    resets = rng.random(v.shape) < 0.03
    v = np.where(np.cumsum(resets, axis=1) % 2 == 1, v * 0.01, v).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.nan
    v[7, 1::2] = np.nan
    return v


CASES = [(kind, name) for kind in ("gauge", "counter") for name in sorted(TF.FUSABLE)
         if kind == "gauge" or not name.startswith("std")]


def _assert_close(got, want, atol, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN pattern differs"
    m = ~np.isnan(want)
    bad = np.abs(got[m] - want[m]) > atol + rtol * np.abs(want[m])
    assert not bad.any(), f"{what}: {bad.sum()} beyond bound, e.g. {got[m][bad][:3]} vs {want[m][bad][:3]}"


@pytest.mark.parametrize("kind,name", CASES)
def test_twin_matches_jnp(kind, name):
    v = _data(kind)
    for w in WINDOWS:
        want = jtf.FUSABLE[name](jnp.asarray(v), w, STEP)
        got = TF.FUSABLE[name](torch.from_numpy(v), w, STEP)
        assert got.dtype == torch.float32
        _assert_close(got.numpy(), want, 1e-5, 1e-5, f"{name} w={w}")


def test_fused_temporal_multi_output_order():
    v = torch.from_numpy(_data("gauge"))
    r, a = TF.fused_temporal(v, 5, STEP, ("rate", "avg_over_time"))
    assert torch.equal(r.nan_to_num(), TF.FUSABLE["rate"](v, 5, STEP).nan_to_num())
    assert torch.equal(a.nan_to_num(), TF.FUSABLE["avg_over_time"](v, 5, STEP).nan_to_num())
    assert torch.equal(TF.temporal_apply("max_over_time", v, 5, STEP).nan_to_num(),
                       TF.FUSABLE["max_over_time"](v, 5, STEP).nan_to_num())


def test_fused_temporal_rejects_bad_arguments():
    v = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        TF.fused_temporal(v, 3, STEP, ("deriv",))
    with pytest.raises(ValueError):
        TF.fused_temporal(v, 0, STEP, ("rate",))
    with pytest.raises(ValueError):
        TF.fused_temporal(v[0], 3, STEP, ("rate",))


@pytest.fixture(scope="module")
def host_b2():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tempfile.mkdtemp(prefix="b2_host_") + "/temporal_fused_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, str(_build.SOURCES["temporal_fused"][0])],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(out).m3_temporal_fused_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("kind", ["gauge", "counter"])
@pytest.mark.parametrize("window", WINDOWS)
def test_kernel_source_host_build_matches_twin(host_b2, kind, window):
    v = np.ascontiguousarray(_data(kind))
    names = [n for n in TF.FUSABLE if kind == "gauge" or not n.startswith("std")]
    outs = [np.zeros_like(v) for _ in names]
    ptrs = (ctypes.c_void_p * len(names))(*[o.ctypes.data for o in outs])
    ids = (ctypes.c_int * len(names))(*[list(TF.FUSABLE).index(n) for n in names])
    assert host_b2(v.ctypes.data, v.shape[0], v.shape[1], window, STEP, ptrs, ids, len(names)) == 0
    twin = TF.fused_temporal(torch.from_numpy(v), window, STEP, tuple(names))
    for name, got, want in zip(names, outs, twin):
        atol = 5e-3 if name.startswith("std") else 1e-4
        _assert_close(got, want.numpy(), atol, 1e-4, f"{name} w={window}")
