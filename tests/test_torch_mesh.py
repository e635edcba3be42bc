"""Port parity for the series mesh (m3_tpu_torch.parallel.mesh) and the
sharded scans (m3_tpu_torch.parallel.scan make_sharded_chunked_scan,
make_sharded_scan, make_sharded_resident_chunked_scan through
resident_scan_totals(mesh=)).

Each world (8, 3 and 5 ranks, as tests/test_mesh.py's 8-device mesh and its
odd sizes) is one spawn of processes (tests/torch_mesh_worker.py, which
imports no JAX) joined by gloo through a FileStore; each rank runs the three
sharded scans over its slice of the series and rank 0 gathers the
per-series arrays. They are held to:

- the port's single-process scans on the same series: per-series arrays
  exactly, totals to rtol 1e-6 (the reduce adds the ranks' partial sums in
  another order; the reference's own tolerance);
- ``m3_tpu``'s make_sharded_chunked_scan / make_sharded_scan on the first N
  devices of the conftest's 8-device CPU mesh, and for the world of 8 its
  resident_scan_totals(mesh=) over a pool holding the same blocks (the
  reference's shard_map refuses 3 and 5 ranks there): counts, err and the
  extremes and last values exactly, per-series and total sums to rtol 1e-6
  (torch and XLA add a series' values in different orders, and XLA's order
  follows its tiling of the shard: the reference's own sharded resident
  test holds its per-series sums to rtol 1e-6 against its single device).

Every spawn has its own deadline (SPAWN_TIMEOUT_S): a rank that has not
exited by then fails the test, and every rank is killed, so a stuck
rendezvous never runs into the suite's clock.
"""

import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from m3_tpu.cache.block_cache import BlockKey as JBlockKey
from m3_tpu.ops import chunked as jchunked
from m3_tpu.parallel import scan as jscan
from m3_tpu.parallel.mesh import SHARD_AXIS, series_sharding as jsharding
from m3_tpu.resident import ResidentOptions as JResidentOptions
from m3_tpu.resident import ResidentPool as JResidentPool
from m3_tpu.resident.scan import resident_scan_totals as jresident_scan_totals
from m3_tpu.segment.batched import BatchedSegments as JBatched
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import fused as tfused
from m3_tpu_torch.ops.decode import batched_device_args
from m3_tpu_torch.parallel import mesh as tmesh
from m3_tpu_torch.parallel import scan as tscan
from m3_tpu_torch.resident import ResidentOptions, ResidentPool, resident_scan_totals
from m3_tpu_torch.segment.batched import BatchedSegments
from m3_tpu_torch.utils import synthetic as tsyn

import torch_mesh_worker as worker

TESTS = pathlib.Path(__file__).resolve().parent
SPAWN_TIMEOUT_S = 120
S, K, T = 120, 8, 64  # 120 series split evenly over 8, 3 and 5 ranks


@pytest.fixture(scope="module")
def streams():
    # gauges, floats and counters (seed 23), byte-identical in both packages
    return tsyn.synthetic_mixed_streams(8, T, seed=23, frac_float=0.25, frac_counter=0.125)


@pytest.fixture(scope="module")
def single(streams):
    """The port's single-process scans of the same S series."""
    batch = tchunked.tile_chunked(tchunked.build_chunked(streams, k=K), S)
    packed = tfused.pack_lanes(batch, order="s", device="cpu")
    args = batched_device_args(BatchedSegments.from_streams(worker.tiled(streams, S)), "cpu")
    pool = ResidentPool(ResidentOptions(max_bytes=8 << 20), device="cpu")
    keys = worker.resident_keys(pool, worker.tiled(streams, S), T, K)
    return {
        "chunked": tscan.chunked_scan_aggregate(packed, S, batch.num_chunks, K),
        "unchunked": tscan.scan_aggregate(*args, T),
        "resident": resident_scan_totals(pool, keys),
    }


def spawn_world(tmp: pathlib.Path, streams, size: int) -> dict:
    """Run ``size`` gloo ranks of torch_mesh_worker over ``streams``;
    returns rank 0's arrays. Fails when a rank exits non-zero or has not
    exited SPAWN_TIMEOUT_S after the spawn."""
    offs = np.cumsum([0] + [len(x) for x in streams])
    np.savez(tmp / "case.npz", data=np.frombuffer(b"".join(streams), np.uint8), offsets=offs,
             s=S, k=K, t=T)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(TESTS / "torch_mesh_worker.py"), str(tmp),
                               str(r), str(size)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(size)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        logs = []
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of a world of {size} still running after "
                            f"{SPAWN_TIMEOUT_S} s")
            if p.returncode != 0:
                pytest.fail(f"rank {r} of a world of {size} exited {p.returncode}:\n"
                            f"{logs[-1][-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(np.load(tmp / "out.npz"))


def jax_sharded(streams, size: int) -> dict:
    """m3_tpu's sharded scans on the first ``size`` CPU devices: the chunked
    and whole-stream ones, and at 8 devices the resident one."""
    mesh = Mesh(np.asarray(jax.devices()[:size]), (SHARD_AXIS,))
    sh = jsharding(mesh)
    batch = jchunked.tile_chunked(jchunked.build_chunked(streams, k=K), S)
    lane_args = jchunked.lane_kwargs(batch, transform=lambda x: jax.device_put(jnp.asarray(x), sh))
    seg = JBatched.from_streams(worker.tiled(streams, S))
    put = lambda x: jax.device_put(jnp.asarray(x), sh)
    out = {
        "chunked": jscan.make_sharded_chunked_scan(mesh, S, batch.num_chunks, K)(lane_args),
        "unchunked": jscan.make_sharded_scan(mesh, T)(put(seg.words), put(seg.num_bits),
                                                      put(seg.initial_units())),
    }
    if size == 8:
        pool = JResidentPool(JResidentOptions(max_bytes=8 << 20))
        items = [(b"%06d" % i, x, T) for i, x in enumerate(worker.tiled(streams, S))]
        res = pool.admit_block("m3", 0, worker.T0, 0, items, chunk_k=K)
        assert res.admitted == len(items) and res.complete, res
        keys = [JBlockKey("m3", 0, it[0], worker.T0, 0) for it in items]
        out["resident"] = jresident_scan_totals(pool, keys, mesh=mesh)
    return out


def _np(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.uint8) if x.dtype == np.bool_ else x


def _same_bits(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
        a, b = np.where(np.isnan(a), 0, a), np.where(np.isnan(b), 0, b)
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("size", [8, 3, 5])
def test_sharded_scans_match_single_and_jax(tmp_path, streams, single, size):
    got = spawn_world(tmp_path, streams, size)
    want_jax = jax_sharded(streams, size)
    for name, want in single.items():
        for f in worker.FIELDS:
            _same_bits(got[f"{name}.{f}"], _np(getattr(want, f)), f"{name} {f}")
        assert int(got[f"{name}.total_count"]) == int(want.total_count), name
        for f in ("total_sum", "total_min", "total_max"):
            np.testing.assert_allclose(float(got[f"{name}.{f}"]), float(getattr(want, f)),
                                       rtol=1e-6, err_msg=f"{name} {f}")
        if name not in want_jax:
            continue
        jw = want_jax[name]
        for f in ("series_count", "series_min", "series_max", "series_last", "series_err"):
            if getattr(jw, f) is not None:
                _same_bits(got[f"{name}.{f}"], np.asarray(getattr(jw, f)),
                           f"{name} {f} vs m3_tpu")
        np.testing.assert_allclose(got[f"{name}.series_sum"], np.asarray(jw.series_sum),
                                   rtol=1e-6, err_msg=f"{name} series_sum vs m3_tpu")
        assert int(got[f"{name}.total_count"]) == int(jw.total_count)
        for f in ("total_sum", "total_min", "total_max"):
            np.testing.assert_allclose(float(got[f"{name}.{f}"]), float(getattr(jw, f)),
                                       rtol=1e-6, err_msg=f"{name} {f} vs m3_tpu")
    assert int(got["chunked.total_count"]) > 0
    assert sorted(want_jax) == (["chunked", "resident", "unchunked"] if size == 8
                                else ["chunked", "unchunked"])


def test_sharded_chunked_scan_refuses_uneven_series():
    mesh = tmesh.SeriesMesh(group=None, rank=0, size=7, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh size 7"):
        tscan.make_sharded_chunked_scan(mesh, 120, 4, K)
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.series_sharding(mesh)(np.zeros(120))


def test_series_mesh_raises_without_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.series_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tscan.sharded_scan_aggregate(torch.zeros((1, 1), dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32), 4)


def test_series_sharding_and_replicated():
    x = np.arange(12)
    got = [tmesh.series_sharding(tmesh.SeriesMesh(None, r, 3, torch.device("cpu")))(x)
           for r in range(3)]
    assert [g.tolist() for g in got] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    mesh = tmesh.SeriesMesh(None, 1, 3, torch.device("cpu"))
    assert tmesh.replicated(mesh)(x) is x
    assert mesh.axis_names == (tmesh.SHARD_AXIS,) == ("shard",)
