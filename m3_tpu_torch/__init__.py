"""m3_tpu_torch — the PyTorch/CUDA port of m3_tpu: the scan-and-aggregate
path and PromQL range queries over M3TSZ blocks.

The package mirrors ``m3_tpu``'s module names so each counterpart is easy to
find (``ops/fused.py`` here is the port of ``m3_tpu/ops/fused.py``). It
imports torch and numpy only: never JAX, never the JAX package.

Entry points take ``device=`` and default to ``"cuda"``. Without a card they
raise; they run on the CPU only when the caller asks for it, as the tests do.
A kernel wrapper launches its CUDA kernel for a CUDA tensor and uses its
plain PyTorch version only for a tensor that lies on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on. Raises if a CUDA device is asked
    for and there is none: nothing falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "m3_tpu_torch: CUDA device requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"m3_tpu_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def device_guard(device: torch.device):
    """``torch.cuda.device(device)``, or nothing when ``device`` is already
    the current one: the guard costs host time on every kernel launch."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
