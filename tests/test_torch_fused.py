"""Port parity for the lane-aggregate kernel (m3_tpu_torch.ops.fused).

- The plain PyTorch twin equals m3_tpu's Pallas kernel
  ``lane_aggregates_packed`` (run in interpret mode, as the JAX package's
  own tests run it on the CPU) PER LANE: count and err exact, sum/min/max/
  last bit-identical with NaN in the same places.
- The f32 conversions equal the reference's formulas bit for bit.
- The CUDA source's per-lane code, compiled as host C++ (it has a host
  build for this), equals the twin per lane, so the kernel's arithmetic is
  checked here although no card is present.
The kernel itself is held to the twin on a card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.codec.m3tsz import Encoder
from m3_tpu.ops import chunked as jchunked
from m3_tpu.ops import decode as jdecode
from m3_tpu.ops import fused as jfused
from m3_tpu.ops import u64
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import decode as tdecode
from m3_tpu_torch.ops import fused as tfused

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 5e-324, 1e-40, -1e-42,
            1e300, -1e300, 3.4e38, 1e-39, -3.0, -1.0, -2.5, 7.0]


def _encode_values(rows):
    out = []
    for vals in rows:
        enc = Encoder(T0)
        for j, v in enumerate(vals):
            enc.encode(T0 + j * NANOS, float(v))
        out.append(enc.stream())
    return out


def _float_repeat_streams():
    """All-float streams with repeated values ('01' repeat records)."""
    rng = np.random.RandomState(3)
    rows = []
    for _ in range(32):
        v, row = 0.12345, []
        for _ in range(97):
            if rng.rand() >= 0.3:
                v = float(rng.lognormal(0, 2))
            row.append(v)
        rows.append(row)
    return _encode_values(rows)


# name -> (streams factory, k, n_series, order)
CASES = {
    "gauge": (lambda: jsyn.synthetic_streams(32, 97, seed=13, kind="gauge"), 16, 1024, "c"),
    "counter": (lambda: jsyn.synthetic_streams(32, 97, seed=13, kind="counter"), 24, 1024, "c"),
    "float": (lambda: jsyn.synthetic_streams(32, 97, seed=13, kind="float"), 24, 1024, "c"),
    "float_repeat": (_float_repeat_streams, 16, 2048, "sorted"),
    "mixed": (lambda: jsyn.synthetic_mixed_streams(64, 97, seed=5, frac_float=0.5),
              16, 4096, "sorted"),
    "annotated": (lambda: jsyn.synthetic_mixed_streams(
        32, 97, seed=31, frac_tu_change=0.2, frac_annotation=0.2), 16, 64, "sorted"),
    # small negative ints: the general body's u64.to_f32 maps -3 to 0.0
    # while the int-fast body gets -3; the port keeps both as written
    "negative_int": (lambda: _encode_values([[-3.0] * 97, [-1.0, -2.0, 0.0, -7.0] * 24 + [-5.0]]),
                     16, 1024, "c"),
    # NaN, infinities, signed zeros, f64 and f32 subnormals, f32 overflow
    # (a first value of -inf cannot be encoded, so each row opens with 0.5)
    "specials": (lambda: _encode_values(
        [[0.5] + [SPECIALS[(j * 7 + s) % len(SPECIALS)] for j in range(96)] for s in range(16)]),
        16, 64, "c"),
    # 21,000 lanes: not a multiple of the kernel's 128-lane slabs, so the
    # last slab holds padding lanes; all three bodies, chunks ending
    # mid-window
    "ragged": (lambda: jsyn.synthetic_mixed_streams(64, 97, seed=9, frac_float=0.5),
               16, 3000, "sorted"),
}


_packed_cache = {}


def _packed(name):
    """(streams, k, torch PackedLanes on cpu)."""
    if name not in _packed_cache:
        make, k, n_series, order = CASES[name]
        streams = make()
        tp = tfused.pack_lanes(tchunked.build_chunked(streams, k=k), order=order, rows=8,
                               device="cpu", n_series=n_series)
        _packed_cache[name] = (streams, k, tp)
    return _packed_cache[name]


def _assert_lanes_identical(got, want):
    np.testing.assert_array_equal(np.asarray(got.count), np.asarray(want.count))
    np.testing.assert_array_equal(np.asarray(got.err), np.asarray(want.err))
    for f in ("sum", "min", "max", "last"):
        g = np.asarray(getattr(got, f), np.float32)
        w = np.asarray(getattr(want, f), np.float32)
        same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g) & np.isnan(w))
        bad = np.nonzero(~same)[0]
        assert bad.size == 0, f"{f} differs at lanes {bad[:5]}: {g[bad[:5]]} vs {w[bad[:5]]}"


def _jax_lanes(name):
    streams, k, _ = _packed(name)
    _, _, n_series, order = CASES[name]
    jb = jchunked.tile_chunked(jchunked.build_chunked(streams, k=k), n_series)
    jp = jfused.pack_lane_inputs(jb, order=order, rows=8)
    return jp, jfused.lane_aggregates_packed(
        jp.windows4, jp.lanes4, jp.tile_flags, n=jp.n, k=k, interpret=True
    )


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_pallas_kernel_per_lane(name):
    _, k, tp = _packed(name)
    jp, want = _jax_lanes(name)
    np.testing.assert_array_equal(tp.tile_flags.numpy(), jp.tile_flags)
    got = tfused.lane_aggregates(tp.windows, tp.lanes, tp.tile_flags, n=tp.n, k=k)
    _assert_lanes_identical(got, want)
    flags = np.bincount(jp.tile_flags, minlength=3)
    if name in ("gauge", "counter", "negative_int"):
        assert flags[1] > 0
    if name in ("float", "float_repeat"):
        assert flags[2] > 0
    if name in ("mixed", "ragged"):
        assert (flags > 0).all(), flags  # all three bodies run
    if name == "annotated":
        assert np.asarray(want.err).any()
    if name == "negative_int":
        # lane 0 is chunk 0 of the all -3 series (general body, to_f32
        # fault); lane 2*S is its chunk 2 (int-fast body)
        s = CASES[name][2]
        assert float(want.min[0]) == 0.0 and float(want.count[0]) == 16
        assert float(want.min[2 * s]) == -3.0
    if name == "specials":
        assert np.isnan(np.asarray(want.sum)).any() and np.isinf(np.asarray(want.max)).any()


def _random_f64_bits(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    parts = [
        rng.integers(0, 2**64, n // 4, dtype=np.uint64),  # any pattern: NaN, inf, subnormal
        rng.lognormal(0, 8, n // 4).view(np.uint64),
        (rng.normal(0, 1, n // 4) * 10.0 ** rng.integers(-45, -30, n // 4)).view(np.uint64),
        (rng.integers(0, 2**52, n // 8, dtype=np.uint64)
         | (rng.integers(0, 2, n // 8, dtype=np.uint64) << np.uint64(63))),  # f64 subnormals
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4028235e38, 3.5e38, 1.17549435e-38,
                  1.1754942e-38, 1e-45, 7e-46, 5e-324, -5e-324], np.float64).view(np.uint64),
    ]
    bits = np.concatenate(parts)
    pad = n - bits.size
    return np.concatenate([bits, rng.integers(0, 2**64, pad, dtype=np.uint64)])


def _split(bits):
    return (bits >> np.uint64(32)).astype(np.uint32), (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _assert_f32_identical(got, want):
    got = got.numpy()
    want = np.asarray(want, np.float32)
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    bad = np.nonzero(~same)[0]
    assert bad.size == 0, f"{bad.size} differ, e.g. {got[bad[:5]]} vs {want[bad[:5]]}"


def test_f64_bits_to_f32_bit_identical():
    hi, lo = _split(_random_f64_bits())
    want = jax.jit(u64.f64_bits_to_f32)((jnp.asarray(hi), jnp.asarray(lo)))
    _assert_f32_identical(tdecode.f64_bits_to_f32((_t(hi), _t(lo))), want)


def _int_pairs(n=100_000, seed=1):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.integers(-2**63, 2**63 - 1, n // 4, dtype=np.int64),
        rng.integers(-1000, 1000, n // 4, dtype=np.int64),
        rng.integers(-2**40, 2**40, n // 4, dtype=np.int64),
        rng.integers(-2**31, 2**31, n - 3 * (n // 4), dtype=np.int64),
    ])
    return _split(vals.view(np.uint64)), rng.integers(-1, 9, vals.size).astype(np.int32)


def test_to_f32_bit_identical():
    (hi, lo), _ = _int_pairs()
    want = jax.jit(u64.to_f32)((jnp.asarray(hi), jnp.asarray(lo)))
    _assert_f32_identical(tdecode.to_f32((_t(hi), _t(lo))), want)
    # the reference's own fault, kept: -3 comes out as 0.0
    m3 = np.array([0xFFFFFFFF], np.uint32), np.array([0xFFFFFFFD], np.uint32)
    assert float(tdecode.to_f32((_t(m3[0]), _t(m3[1])))[0]) == 0.0


def test_int_val_to_f32_bit_identical():
    (hi, lo), mult = _int_pairs(seed=2)
    want = jax.jit(jdecode._int_val_to_f32)((jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(mult))
    _assert_f32_identical(tdecode._int_val_to_f32((_t(hi), _t(lo)), _t(mult)), want)
    iv = lo.view(np.int32)
    want32 = jax.jit(jdecode._int32_val_to_f32)(jnp.asarray(iv), jnp.asarray(mult))
    _assert_f32_identical(tdecode._int32_val_to_f32(_t(iv), _t(mult)), want32)


# ---------------------------------------------------------------------------
# The CUDA source's arithmetic, compiled for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "lane_aggregates_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["lane_aggregates"][0])],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(str(out)).m3_lane_aggregates_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_source_host_build_matches_twin(host_kernel, name):
    """The card's path: 128-lane slabs of window rows staged as the kernel
    stages them, one fetch per fast record."""
    _, k, tp = _packed(name)
    cw, npad = tp.windows.shape
    out_f = np.zeros((4, npad), np.float32)
    out_cnt = np.zeros(npad, np.int32)
    out_err = np.zeros(npad, np.uint8)
    win, lanes, flags = tp.windows.numpy(), tp.lanes.numpy(), tp.tile_flags.numpy()
    rc = host_kernel(win.ctypes.data, lanes.ctypes.data, flags.ctypes.data, npad, cw,
                     tdecode.barrel_mask(cw), k, npad // flags.size, out_f.ctypes.data,
                     out_cnt.ctypes.data, out_err.ctypes.data)
    assert rc == 0
    n = tp.n
    got = tfused.LaneAggregates(sum=out_f[0, :n], count=out_cnt[:n], min=out_f[1, :n],
                                max=out_f[2, :n], last=out_f[3, :n], err=out_err[:n] != 0)
    want = tfused.lane_aggregates(tp.windows, tp.lanes, tp.tile_flags, n=n, k=k)
    _assert_lanes_identical(got, want)


@pytest.mark.parametrize("npad,tile_lanes", [(3840, 64), (4000, 1000)])
def test_kernel_refuses_tiles_off_its_slabs(host_kernel, npad, tile_lanes):
    """Tiles that are not whole 128-lane slabs: the wrapper raises on every
    device, and the kernel source refuses them."""
    cw = 6
    win = torch.zeros((cw, npad), dtype=torch.int32)
    lanes = torch.zeros((tfused.NLANE, npad), dtype=torch.int32)
    flags = torch.zeros(npad // tile_lanes, dtype=torch.int32)
    with pytest.raises(ValueError, match="128 lanes"):
        tfused.lane_aggregates(win, lanes, flags, n=npad, k=4)
    out_f = np.zeros((4, npad), np.float32)
    out_cnt = np.zeros(npad, np.int32)
    out_err = np.zeros(npad, np.uint8)
    rc = host_kernel(win.numpy().ctypes.data, lanes.numpy().ctypes.data,
                     flags.numpy().ctypes.data, npad, cw, tdecode.barrel_mask(cw), 4, tile_lanes,
                     out_f.ctypes.data, out_cnt.ctypes.data, out_err.ctypes.data)
    assert rc == 1


def test_kernel_input_copies_only_misaligned_storage():
    """The kernels' 16-byte copies need aligned inputs: a contiguous view off
    a 16-byte boundary is copied and counted, anything else is not."""
    base = torch.arange(4 * 130, dtype=torch.int32)
    aligned = base[:4 * 128].view(4, 128)
    before = tfused.UNALIGNED_COPIES
    assert tfused.kernel_input(aligned).data_ptr() == aligned.data_ptr()
    strided = base.view(4, 130)[:, 1:129]  # not contiguous: a fresh copy anyway
    got = tfused.kernel_input(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    assert tfused.UNALIGNED_COPIES == before
    shifted = base[1:1 + 4 * 128].view(4, 128)
    assert shifted.data_ptr() % 16
    got = tfused.kernel_input(shifted)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, shifted)
    assert tfused.UNALIGNED_COPIES == before + 1


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "lane_aggregates_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["lane_aggregates"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.m3_lane_smem_bytes.restype = ctypes.c_int64
    lib.m3_lane_smem_max_bytes.restype = ctypes.c_int64
    return lib


def _launch_shape_ok(lib, kernel, cw):
    try:
        tfused.check_launch_shape(lib, kernel, cw)
    except ValueError as e:
        assert f"CW={cw}" in str(e)
        return False
    return True


@pytest.mark.parametrize("kernel", list(tfused.LANE_KERNELS))
def test_check_launch_shape_matches_the_kernel_source(host_lib, kernel):
    """check_launch_shape, asking the kernel source for its shared memory
    layout, takes the widest windows the source's entries take and raises,
    naming the shape, on the next width: the wrappers refuse a shape before
    any launch."""
    widths = [cw for cw in range(0, 600) if _launch_shape_ok(host_lib, kernel, cw)]
    cw_max = widths[-1]
    assert widths == list(range(1, cw_max + 1)) and cw_max >= 24
    n, k, vp = 128, 4, ctypes.c_void_p
    for cw, want in ((cw_max, 0), (cw_max + 1, 1)):
        win = np.zeros((cw, n), np.uint32)
        planes = np.zeros((tfused.NLANE, n), np.uint32)
        out = np.zeros(64 * n * k, np.uint8)  # room for any entry's outputs
        o = out.ctypes.data
        mask = tdecode.barrel_mask(cw)
        if kernel == "lane_aggregates":
            fn = host_lib.m3_lane_aggregates_host
            flags = np.zeros(1, np.int32)
            rc = fn(vp(win.ctypes.data), vp(planes.ctypes.data), vp(flags.ctypes.data),
                    ctypes.c_int64(n), cw, mask, k, ctypes.c_int64(n), vp(o), vp(o + 16 * n),
                    vp(o + 20 * n))
        elif kernel == "decode_records":
            fn = host_lib.m3_decode_records_host
            rc = fn(vp(win.ctypes.data), vp(planes.ctypes.data), ctypes.c_int64(n),
                    ctypes.c_int64(n), cw, mask, k, vp(o), vp(o + 8 * n * k), vp(o + 16 * n * k),
                    vp(o + 17 * n * k), vp(o + 18 * n * k), vp(o + 19 * n * k))
        else:
            fn = host_lib.m3_lane_aggregates_fields_host
            fields = (vp * tfused.NLANE)(*[planes[i].ctypes.data for i in range(tfused.NLANE)])
            rows = np.ascontiguousarray(win.T)
            rc = fn(vp(rows.ctypes.data), fields, ctypes.c_int64(n), cw, mask, k, vp(o),
                    vp(o + 16 * n), vp(o + 20 * n))
        assert rc == want, (cw, rc)
