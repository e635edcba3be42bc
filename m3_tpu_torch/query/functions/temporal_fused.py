"""Fused temporal-function evaluation: kernel B2.

Port of ``m3_tpu/query/functions/temporal_fused.py``. ``fused_temporal``
evaluates any of the 15 ``FUSABLE`` functions over one f32 [S, T] range
matrix: for a CUDA tensor in one launch of the CUDA kernel
(``csrc/temporal_fused.cu``, one f32 [S, T] output per function), for a
CPU tensor with the plain PyTorch twin (``temporal.py``). The TPU's
64-row blocks, NaN row padding and row-count gate are gone: each row is
one warp's on the card, and the function ids pick the kernel's
instantiation (the state groups those functions need).
"""

from __future__ import annotations

import ctypes

import torch

from ... import device_guard
from ...ops._build import load_library
from ...utils.instrument import KernelProfiler
from . import temporal as T

# dispatch observability for kernel B2: dispatch counts, first-sighting
# attribution, sampled dispatch seconds (M3_TPU_PROFILE_SAMPLE_RATE) and
# the launch's cost (``launch_cost``). As the reference profiles only its
# TPU kernel, only a launch on the card dispatches through it: the CPU
# twin is not a dispatch.
_JIT = KernelProfiler("temporal_fused")

# name -> twin(values, window, step_seconds); the order is the kernel's
# function ids (enum Fn of csrc/temporal_fused.cu)
FUSABLE = {
    "rate": lambda v, w, s: T.rate(v, w, s),
    "irate": lambda v, w, s: T.irate(v, w, s),
    "increase": lambda v, w, s: T.increase(v, w, s),
    "delta": lambda v, w, s: T.delta(v, w, s),
    "idelta": lambda v, w, s: T.idelta(v, w, s),
    "resets": lambda v, w, s: T.resets(v, w),
    "changes": lambda v, w, s: T.changes(v, w),
    "sum_over_time": lambda v, w, s: T.sum_over_time(v, w),
    "count_over_time": lambda v, w, s: T.count_over_time(v, w),
    "avg_over_time": lambda v, w, s: T.avg_over_time(v, w),
    "min_over_time": lambda v, w, s: T.min_over_time(v, w),
    "max_over_time": lambda v, w, s: T.max_over_time(v, w),
    "last_over_time": lambda v, w, s: T.last_over_time(v, w),
    "stddev_over_time": lambda v, w, s: T.stddev_over_time(v, w),
    "stdvar_over_time": lambda v, w, s: T.stdvar_over_time(v, w),
}
_FN_ID = {name: i for i, name in enumerate(FUSABLE)}

# Launches of the CUDA kernel, counted by fused_temporal where it launches.
LAUNCHES = 0


def fused_temporal(values, window: int, step_seconds: float, funcs: tuple[str, ...]):
    """Evaluate ``funcs`` over the same [S, T] range matrix. Returns a
    tuple of f32 [S, T] tensors in ``funcs`` order, on ``values``' device.

    For a CUDA tensor this launches the kernel once (and raises if the
    build or the launch fails); for a CPU tensor it runs the twin."""
    unknown = [f for f in funcs if f not in FUSABLE]
    if unknown or not funcs:
        raise ValueError(f"not fusable: {unknown or 'no functions'}")
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    values = torch.as_tensor(values)
    if values.dim() != 2:
        raise ValueError(f"want a [S, T] matrix, got shape {tuple(values.shape)}")
    v = values.to(torch.float32)
    if v.device.type == "cpu":
        return tuple(FUSABLE[f](v, window, step_seconds) for f in funcs)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.numel() == 0:  # nothing to launch
        return tuple(torch.empty_like(v) for _ in funcs)
    args = (v.contiguous(), int(window), float(step_seconds), tuple(funcs))
    with _JIT.dispatch((args[3], tuple(v.shape), args[1], args[2]),
                       cost=(launch_cost, args, {})) as d:
        return d.done(_launch(*args))


def launch_cost(v, window: int, step_seconds: float, funcs: tuple) -> dict:
    """B2's work on one launch, for ``KernelProfiler.capture_cost``: it
    reads the f32 [S, T] matrix once and writes one per function; its
    operations are counted as avg_over_time's (2 a window element and 1 a
    column) for each function."""
    rows, cols = v.shape
    win_elems = sum(min(window, t + 1) for t in range(cols))
    return {"flops": float(rows * (2 * win_elems + cols) * len(funcs)),
            "bytes_accessed": float(rows * cols * 4 * (1 + len(funcs)))}


def _launch(v, window, step_seconds, funcs):
    global LAUNCHES
    lib = load_library("temporal_fused")
    rows, cols = v.shape
    outs = [torch.empty_like(v) for _ in funcs]
    ptrs = (ctypes.c_void_p * len(funcs))(*[o.data_ptr() for o in outs])
    ids = (ctypes.c_int * len(funcs))(*[_FN_ID[f] for f in funcs])
    # rows too long for shared memory keep the kernel's per-row arrays in a
    # device scratch buffer (0 bytes when they fit)
    nbytes = lib.m3_temporal_fused_scratch_bytes(rows, cols, window, ids, len(funcs))
    if nbytes < 0:
        raise ValueError(f"temporal_fused kernel does not take {funcs}")
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=v.device) if nbytes else None
    # pointers and sizes go to ctypes as plain ints (the entry's argtypes
    # convert them; cheaper than a c_void_p object each)
    with device_guard(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.m3_temporal_fused(
            v.data_ptr(), rows, cols, window, step_seconds, ptrs, ids, len(funcs),
            0 if scratch is None else scratch.data_ptr(), nbytes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"temporal_fused kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return tuple(outs)


def temporal_apply(name: str, values, window: int, step_seconds: float):
    """Single-function entry used by the query engine."""
    return fused_temporal(values, window, step_seconds, (name,))[0]
