"""Design experiments on kernel B-6 (the whole-stream decode) on one card.

    python3 b6_variants.py --parent TREE/m3_tpu_torch/ops/csrc/lane_aggregates.cu

Edited copies of the parent commit's and of this checkout's
m3_tpu_torch/ops/csrc/lane_aggregates.cu are built side by side (nvcc, the
library's flags, one process each), held to the parent's outputs on
chip_smoke.py's [batched] parity set (both modes) and on its scan's inputs
(1,048,576 series x 720 gauge points, 64 unique streams of seed 3, tiled),
and timed there in turns (each variant in order, then in reverse; a median
of 3 single launches, CUDA events). The copies of the parent apportion its
time: its stores replaced by one checksum a series (parent_nostore), its
fetches served from the 64 rows the tiled streams repeat (parent_reused:
the same streams on the scan's inputs, so the same outputs there; the
parity set does not tile 64), both (parent_both). The copies of
this checkout take one part of its design away each: runs of 8 records a
flush (group8), runs of 32 with one warp a block (group32), no ring
(ring0), no warp votes (novotes), and its global stores suppressed (nostore,
the walk and flushes alone). A variant whose stores are taken away is not
compared. Prints each variant's ptxas report, its comparison and its times;
the design and its numbers are in PERF.md.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OWN = ROOT / "m3_tpu_torch" / "ops" / "csrc" / "lane_aggregates.cu"

# the parent's (PR 21's) kernel: its per-record stores, and its row
PARENT_EMIT = """  out_err[row] = walk_stream<kIntOpt>(
      L, __ldg(num_bits + row), __ldg(initial_unit + row), t,
      [&](int idx, bool ok, const State& st) { out.put(base + idx, st, ok); }) ? 1 : 0;"""
PARENT_CHECKSUM = """  uint64_t acc = 0;
  const bool e_ = walk_stream<kIntOpt>(
      L, __ldg(num_bits + row), __ldg(initial_unit + row), t,
      [&](int idx, bool ok, const State& st) {
        const uint64_t b = st.is_float ? st.prev_float_bits : st.int_val;
        const float v = st.is_float ? f64_bits_to_f32(b) : to_f32(b) * mult_rcp(st.mult);
        const float f = ok && v == v ? v : __int_as_float(0x7FC00000);
        acc = (acc ^ st.prev_time ^ b ^ (uint64_t)(uint32_t)__float_as_int(f) ^
               ((uint64_t)st.mult << 3) ^ (st.is_float ? 1ull : 0ull) ^ (ok ? 2ull : 0ull)) *
                  0x9E3779B97F4A7C15ull + (uint64_t)idx;
      });
  out.ts[row] = (int64_t)acc;
  out_err[row] = e_ ? 1 : 0;"""
PARENT_ROW = ("const StreamLane L{words + row * w, w};",
              "const StreamLane L{words + (row & 63) * w, w};")
# this checkout's kernel: a store that (practically) never happens keeps
# the values it would store computed
OWN_NOSTORE = ("  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);",
               "  if ((a ^ b ^ c ^ d) == 0x5A5A1234u && a == 77u)\n"
               "    *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);")
OWN_NOVOTES = [
    ("    const bool all_plain = group_all<G>(plain);",
     "    const bool all_plain = false && group_all<G>(plain);"),
    ("    } else if (group_all<G>(in_int)) {", "    } else if (false && group_all<G>(in_int)) {"),
    ("    } else if (group_all<G>(in_float)) {",
     "    } else if (false && group_all<G>(in_float)) {"),
]


def variants(parent_src: str) -> dict:
    """name -> (base source, [(old, new), ...], where it is held to the
    parent: "all", "main" (the scan's inputs only) or None)."""
    own = OWN.read_text()
    return {
        "parent": (parent_src, [], "all"),
        "parent_nostore": (parent_src, [(PARENT_EMIT, PARENT_CHECKSUM)], None),
        "parent_reused": (parent_src, [PARENT_ROW], "main"),
        "parent_both": (parent_src, [(PARENT_EMIT, PARENT_CHECKSUM), PARENT_ROW], None),
        "new": (own, [], "all"),
        "group8": (own, [("kB6Group = 16;", "kB6Group = 8;")], "all"),
        "group32": (own, [("kB6Group = 16;", "kB6Group = 32;"), ("kB6Warps = 4;", "kB6Warps = 1;")],
                    "all"),
        "ring0": (own, [("kB6Ring = 32;", "kB6Ring = 0;")], "all"),
        "novotes": (own, OWN_NOVOTES, "all"),
        "nostore": (own, [OWN_NOSTORE], None),
    }


def build(parent: Path, out_dir: Path) -> dict:
    """Each variant's C entry m3_decode_batched, built in parallel."""
    from m3_tpu_torch.ops import _build

    header = ROOT / "m3_tpu_torch" / "csrc" / "launch.cuh"
    src_dir = out_dir / "ops" / "csrc"  # the sources include ../../csrc/launch.cuh
    src_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "csrc").mkdir(exist_ok=True)
    (out_dir / "csrc" / "launch.cuh").write_text(header.read_text())
    flags = _build.SOURCES["lane_aggregates"][1]
    procs = {}
    for name, (text, edits, compared) in variants(parent.read_text()).items():
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{name}: the source has no {old.splitlines()[0]!r}")
            text = text.replace(old, new)
        src = src_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"{name}.so"
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *flags, "-o", str(lib), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, compared)
    fns = {}
    for name, (proc, lib, compared) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{text}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "decode_batched" in line:
                info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                print(f"[{name}] ptxas {'<true>' if 'ILb1E' in line else '<false>'}: "
                      f"{' | '.join(info)}")
        fn = ctypes.CDLL(str(lib)).m3_decode_batched
        fn.argtypes = _build.SOURCES["lane_aggregates"][2]["m3_decode_batched"]
        fn.restype = ctypes.c_int
        fns[name] = (fn, compared)
    return fns


def outputs(s: int, t: int):
    import torch

    return (torch.empty((s, t), dtype=torch.int64, device="cuda"),
            torch.empty((s, t), dtype=torch.int64, device="cuda"),
            torch.empty((3, s, t), dtype=torch.uint8, device="cuda"),
            torch.empty((s,), dtype=torch.uint8, device="cuda"),
            torch.empty((s, t), dtype=torch.int32, device="cuda"))


def launch(fn, args, t: int, io: int, out) -> None:
    import torch

    words, nb, iu = args
    s, w = words.shape
    ts, bits, small, err, vals = out
    rc = fn(words.data_ptr(), nb.data_ptr(), iu.data_ptr(), s, w, t, io, ts.data_ptr(),
            bits.data_ptr(), small[0].data_ptr(), small[1].data_ptr(), small[2].data_ptr(),
            err.data_ptr(), vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"a B-6 launch failed: CUDA error {rc}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, metavar="CU",
                    help="the parent commit's m3_tpu_torch/ops/csrc/lane_aggregates.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6_variants: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from m3_tpu_torch.ops import decode
    from m3_tpu_torch.segment.batched import BatchedSegments
    from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams, tiled_batch

    print(cs.card_line())
    t0 = time.perf_counter()
    fns = build(Path(args.parent).resolve(), ROOT / "build" / "b6_variants")
    print(f"built {len(fns)} variants in parallel in {time.perf_counter() - t0:.1f}s")
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))

    t = cs.N_POINTS
    uniq = [x for kind, _, _ in cs.KINDS for x in cs.phase_streams(kind)]
    uniq += synthetic_mixed_streams(cs.N_UNIQUE, t, seed=7, frac_tu_change=0.1,
                                    frac_annotation=0.05)
    seg = BatchedSegments.from_streams([uniq[i % len(uniq)] for i in range(cs.PARITY_SERIES)])
    inp = decode.batched_device_args(seg, device="cuda")
    ref, got = outputs(cs.PARITY_SERIES, t), outputs(cs.PARITY_SERIES, t)
    for io in (1, 0):
        launch(fns["parent"][0], inp, t, io, ref)
        for name, (fn, compared) in fns.items():
            if compared == "all" and name != "parent":
                launch(fn, inp, t, io, got)
                if not same(got, ref):
                    raise AssertionError(f"{name} != parent on the parity set, io={io}")
    del ref, got

    seg = tiled_batch(cs.MAIN_SERIES, t, n_unique=cs.N_UNIQUE, seed=3)
    inp = decode.batched_device_args(seg, device="cuda")
    ref, got = outputs(cs.MAIN_SERIES, t), outputs(cs.MAIN_SERIES, t)
    launch(fns["parent"][0], inp, t, 1, ref)
    for name, (fn, compared) in fns.items():
        if compared and name != "parent":
            launch(fn, inp, t, 1, got)
            if not same(got, ref):
                raise AssertionError(f"{name} != parent at [{cs.MAIN_SERIES}, {t}]")
    print(f"every compared variant == the parent, every output bit for bit, on the "
          f"[{cs.PARITY_SERIES}, {t}] parity set (both modes) and at [{cs.MAIN_SERIES}, {t}], "
          f"W={seg.num_words}")
    del ref
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        fn = fns[name][0]
        run = lambda: launch(fn, inp, t, 1, got)
        run()
        times[name].append(statistics.median(cs.cuda_ms(run, 3)))
    for name, ms in times.items():
        print(f"[b6_variants] {name:15s} " + " ".join(f"{x:.3f}" for x in ms)
              + f" ms at [{cs.MAIN_SERIES}, {t}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
