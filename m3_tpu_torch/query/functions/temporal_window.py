"""Windowed temporal functions: kernel B-7.

``deriv``, ``predict_linear``, ``holt_winters`` and ``quantile_over_time``
over one f32 [S, T] range matrix: for a CUDA tensor one launch of the CUDA
kernel (``csrc/temporal_window.cu``), for a CPU tensor the plain PyTorch
twin (``temporal.py``). They replace the reference's XLA programs, which
gather [S, 128, W] windows a chunk of steps at a time
(``m3_tpu/query/functions/temporal.py:419-602``); the kernel stages each
row in shared memory with its validity bitmask and computes only the
output columns the caller keeps (``first=``).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import device_guard
from ...ops._build import launch_error, load_library
from . import temporal as T

# name -> twin(values, window, step_seconds, *args); the order is the
# kernel's function ids (enum Fn of csrc/temporal_window.cu)
FUNCTIONS = {
    "deriv": lambda v, w, s: T.deriv(v, w, s),
    "predict_linear": lambda v, w, s, t: T.predict_linear(v, w, s, t),
    "holt_winters": lambda v, w, s, sf, tf: T.holt_winters(v, w, sf, tf),
    "quantile_over_time": lambda v, w, s, q: T.quantile_over_time(v, w, q),
}
_FN_ID = {name: i for i, name in enumerate(FUNCTIONS)}
_NARGS = {"deriv": 0, "predict_linear": 1, "holt_winters": 2, "quantile_over_time": 1}

# Launches of the CUDA kernel, counted by temporal_window where it launches.
LAUNCHES = 0


def _params(name: str, step_seconds: float, args) -> tuple[float, float, float, float]:
    """The kernel's four f32 parameters (see the .cu's note)."""
    if name == "deriv":
        return (step_seconds, 0.0, 0.0, 0.0)
    if name == "predict_linear":
        return (step_seconds, args[0], 0.0, 0.0)
    if name == "holt_winters":
        sf, tf = args
        return (sf, 1 - sf, tf, 1 - tf)
    q = args[0]
    return (q, -1.0 if q < 0 else 1.0 if q > 1 else 0.0, 0.0, 0.0)


def temporal_window(name: str, values, window: int, step_seconds: float, *args,
                    first: int = 0, run: int = 0, force_global: bool = False):
    """``name`` (one of ``FUNCTIONS``) over the [S, T] range matrix
    ``values``: f32 [S, T - first] on its device, the output columns
    ``first`` .. T-1 (column t's window covers input columns t-W+1 .. t;
    the engine keeps the columns from ``first = window - 1`` on). ``args``:
    predict_linear's seconds ahead, holt_winters' (sf, tf),
    quantile_over_time's q.

    For a CUDA tensor this launches B-7 once over the kept columns (and
    raises if the build or the launch fails); for a CPU tensor it returns
    the twin's output sliced at ``first``. ``run`` (the quantile's output
    steps a thread) and ``force_global`` (the route of rows too long for
    shared memory) are the card tests' overrides."""
    if name not in FUNCTIONS:
        raise ValueError(f"not a B-7 function: {name!r}")
    if len(args) != _NARGS[name]:
        raise ValueError(f"{name} takes {_NARGS[name]} parameters, got {len(args)}")
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    values = torch.as_tensor(values)
    if values.dim() != 2:
        raise ValueError(f"want a [S, T] matrix, got shape {tuple(values.shape)}")
    if not 0 <= first <= values.shape[1]:
        raise ValueError(f"first must be in [0, {values.shape[1]}], got {first}")
    v = values.to(torch.float32)
    if v.device.type == "cpu":
        return FUNCTIONS[name](v, window, step_seconds, *args)[:, first:]
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.shape[0] == 0 or v.shape[1] == first:  # nothing to launch
        return v.new_empty((v.shape[0], v.shape[1] - first))
    return _launch(name, v.contiguous(), int(window), int(first),
                   _params(name, float(step_seconds), args), run, force_global)


def _launch(name, v, window, first, params, run, force_global):
    global LAUNCHES
    lib = load_library("temporal_window")
    rows, cols = v.shape
    fn = _FN_ID[name]
    out = v.new_empty((rows, cols - first))
    nbytes = lib.m3_temporal_window_scratch_bytes(rows, cols, window, first, fn, run,
                                                  int(force_global))
    if nbytes < 0:
        raise ValueError(f"temporal_window kernel does not take {name} at [{rows}, {cols}] w={window}")
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=v.device) if nbytes else None
    with device_guard(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.m3_temporal_window(
            v.data_ptr(), rows, cols, window, first, fn, *params, run, int(force_global),
            out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), nbytes, stream,
        )
    if rc != 0:
        raise launch_error("temporal_window", rc, values=v, out=out, scratch=scratch)
    LAUNCHES += 1
    return out


def launch_shape(name: str, rows: int, cols: int, window: int, first: int = 0, run: int = 0,
                 force_global: bool = False) -> dict:
    """How B-7 lays out a launch at this shape: threads a block, output
    columns a thread (the quantile's run), staged in shared memory or not,
    shared memory bytes a block, blocks (the persistent grid the card
    holds), scratch bytes, the staged quantile's rows a warp and lanes a
    row, and whether the linear functions use fold tables."""
    lib = load_library("temporal_window")
    out = np.zeros(9, np.int64)
    if lib.m3_temporal_window_shape(rows, cols, window, first, _FN_ID[name], run,
                                    int(force_global), out.ctypes.data) != 0:
        raise ValueError(f"no launch at [{rows}, {cols}] w={window} first={first}")
    keys = ("threads", "run", "staged", "smem_bytes", "blocks", "scratch_bytes", "rows_per_warp",
            "lanes_per_row", "tables")
    return dict(zip(keys, (int(x) for x in out)))
