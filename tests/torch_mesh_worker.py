"""One rank of a gloo world for tests/test_torch_mesh.py. Imports torch,
numpy and the port only, so a spawned rank never imports JAX.

    python tests/torch_mesh_worker.py DIR RANK SIZE

DIR holds ``case.npz`` (the unique streams, the series count, k and
max_points). The rank joins the world through a FileStore in DIR, runs the
port's three sharded scans over its slice of the series (the chunked scan
over kernel R's lanes, the whole-stream scan over B-6 and the resident scan
over B-2 and B1) and, as rank 0, writes every per-series array gathered over
the world and the all-reduced totals to ``DIR/out.npz``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

FIELDS = ("series_sum", "series_count", "series_min", "series_max", "series_last",
          "series_err")
TOTALS = ("total_sum", "total_count", "total_min", "total_max")
T0 = 1_600_000_000 * 10**9


def case_streams(case) -> list[bytes]:
    data, offs = case["data"], case["offsets"]
    return [data[offs[i]:offs[i + 1]].tobytes() for i in range(len(offs) - 1)]


def tiled(streams, s):
    return [streams[i % len(streams)] for i in range(s)]


def resident_keys(pool, streams, t: int, k: int):
    """Admit the series into ``pool`` (one block); returns their keys."""
    from m3_tpu_torch.cache.block_cache import BlockKey

    items = [(b"%06d" % i, x, t) for i, x in enumerate(streams)]
    res = pool.admit_block("m3", 0, T0, 0, items, chunk_k=k)
    assert res.admitted == len(items) and res.complete, res
    return [BlockKey("m3", 0, it[0], T0, 0) for it in items]


def sharded_scans(mesh, streams, s: int, k: int, t: int) -> dict:
    """The three sharded scans of this rank: name -> ScanAggregates."""
    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.ops.decode import batched_device_args
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.parallel.mesh import series_sharding
    from m3_tpu_torch.resident import ResidentOptions, ResidentPool, resident_scan_totals
    from m3_tpu_torch.segment.batched import BatchedSegments

    shard = series_sharding(mesh)
    rows = shard.rows(s)
    batch = chunked.tile_chunked(chunked.build_chunked(streams, k=k), s)
    local = chunked.select_series(batch, np.arange(rows.start, rows.stop))
    packed = fused.pack_lanes(local, order="s", device=mesh.device)
    out = {"chunked": scan.make_sharded_chunked_scan(mesh, s, batch.num_chunks, k)(packed)}
    args = batched_device_args(BatchedSegments.from_streams(tiled(streams, s)), mesh.device)
    out["unchunked"] = scan.make_sharded_scan(mesh, t)(*(shard(x) for x in args))
    pool = ResidentPool(ResidentOptions(max_bytes=8 << 20), device=mesh.device)
    keys = resident_keys(pool, tiled(streams, s), t, k)
    out["resident"] = resident_scan_totals(pool, keys, mesh=mesh)
    return out


def main(tmp: str, rank: int, size: int) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), size)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=size)
    try:
        from m3_tpu_torch.parallel.mesh import series_mesh

        mesh = series_mesh()
        assert (mesh.rank, mesh.size, mesh.device.type) == (rank, size, "cpu")
        case = np.load(os.path.join(tmp, "case.npz"))
        out = sharded_scans(mesh, case_streams(case), int(case["s"]), int(case["k"]),
                            int(case["t"]))
        arrays = {}
        for name, aggs in out.items():
            for f in FIELDS:
                x = getattr(aggs, f)
                if name != "resident":  # the resident scan gathers its own
                    x = mesh.all_gather(x.to(torch.uint8) if x.dtype == torch.bool else x)
                arrays[f"{name}.{f}"] = x.numpy()
            for f in TOTALS:
                arrays[f"{name}.{f}"] = getattr(aggs, f).numpy()
        if rank == 0:
            np.savez(os.path.join(tmp, "out.npz"), **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
