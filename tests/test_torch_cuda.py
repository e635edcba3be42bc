"""The CUDA lane-aggregate kernel against its plain PyTorch twin, on a card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The file imports torch and the port only, so it runs on
a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from m3_tpu_torch.codec.m3tsz import encode_series
from m3_tpu_torch.ops import chunked, fused
from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams, synthetic_streams

T0 = 1_600_000_000 * 10**9
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 5e-324, 1e-40, -1e-42,
            1e300, -1e300, 3.4e38, 1e-39, -3.0, -1.0, -2.5, 7.0]


def _streams(name):
    if name == "gauge":
        return synthetic_streams(32, 97, seed=13)
    if name == "mixed":
        return synthetic_mixed_streams(64, 97, seed=5, frac_float=0.5)
    return [encode_series([T0 + j * 10**9 for j in range(97)],
                          [0.5] + [SPECIALS[(j * 7 + s) % len(SPECIALS)] for j in range(96)])
            for s in range(16)]


def _assert_identical(got, want):
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.err, want.err)
    for f in ("sum", "min", "max", "last"):
        x, y = getattr(got, f), getattr(want, f)
        same = (x.view(torch.int32) == y.view(torch.int32)) | (torch.isnan(x) & torch.isnan(y))
        assert bool(same.all()), f


@pytest.mark.cuda
@pytest.mark.parametrize("name,order", [("gauge", "c"), ("mixed", "sorted"), ("specials", "c")])
def test_cuda_kernel_matches_twin(name, order):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    batch = chunked.build_chunked(_streams(name), k=16)
    p = fused.pack_lanes(batch, order=order, rows=8, device="cuda", n_series=4096)
    before = fused.LAUNCHES
    got = fused.lane_aggregates(p.windows, p.lanes, p.tile_flags, n=p.n, k=16)
    assert fused.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = fused.lane_aggregates_reference(p.windows, p.lanes, p.tile_flags, n=p.n, k=16)
    _assert_identical(got, want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    win = torch.zeros((6, 1024), dtype=torch.int64, device="cuda")
    lanes = torch.zeros((fused.NLANE, 1024), dtype=torch.int32, device="cuda")
    flags = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        fused.lane_aggregates(win, lanes, flags, n=1024, k=4)
